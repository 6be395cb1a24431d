"""Hand-written Hopper kernels of the port, with their launch counters.

``LAUNCHES`` counts, per kernel instantiation, the launches its wrapper made
on a CUDA tensor that ran: a call that runs the plain PyTorch version on a
CPU tensor does not count, nor does a call captured into a CUDA graph
(nothing runs then), nor the replay of a graph. chip_smoke.py zeroes the
counts before each path it drives (the proof path, the tools) and reads them
after it, to show that the path went through its kernels.
"""

from __future__ import annotations

import torch

LAUNCHES = {
    "mont_mul_fr": 0,
    "mont_mul_fq": 0,
    "mont_inv_fr": 0,
    "mont_inv_fq": 0,
    "g1_add": 0,
    "g2_add": 0,
    "g1_add01": 0,
    "g2_add01": 0,
    "affine_pre": 0,
    "affine_post": 0,
    "affine_pre_g2": 0,
    "affine_post_g2": 0,
    "int8_dot": 0,
    "int8_dot_loop": 0,
    "mont_mul_mxu": 0,
    "jubjub_add": 0,
    "pedersen_fold": 0,
    "fr_sqrt": 0,
}


def count_launch(name: str) -> None:
    """One launch of ``name`` more, unless the current stream is capturing
    a CUDA graph."""
    if not torch.cuda.is_current_stream_capturing():
        LAUNCHES[name] += 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


__all__ = ["LAUNCHES", "count_launch", "reset_launches"]
