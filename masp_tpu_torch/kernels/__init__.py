"""Hand-written Hopper kernels of the port, with their launch counters.

``LAUNCHES`` counts, per kernel instantiation, the launches its wrapper made
on a CUDA tensor; a call that runs the plain PyTorch version on a CPU tensor
does not count. chip_smoke.py zeroes the counts before the proof path and
reads them after it, to show that the path went through every kernel.
"""

from __future__ import annotations

LAUNCHES = {
    "mont_mul_fr": 0,
    "mont_mul_fq": 0,
    "g1_add": 0,
    "g2_add": 0,
    "g1_add01": 0,
    "g2_add01": 0,
    "affine_pre": 0,
    "affine_post": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


__all__ = ["LAUNCHES", "reset_launches"]
