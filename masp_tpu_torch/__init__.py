"""masp_tpu_torch: the Groth16 prover of masp_tpu, ported to PyTorch and
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The package imports torch and numpy, never jax and nothing of masp_tpu: the
host modules it needs are copies under ``host/``. Entry points take a
``device`` argument that defaults to ``"cuda"``; asking for CUDA on a machine
without a card raises, it never falls back to the CPU. Tests pass
``device="cpu"``, where every kernel wrapper runs its plain PyTorch version.
"""

from __future__ import annotations

import torch


_CONSTS: dict = {}


def device_const(key, build):
    """A constant tensor built once per key (the key includes the device):
    hot paths then make no host-to-device copy, which from pageable memory
    would wait for the card's queue to drain."""
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = build()
    return t


def resolve_device(device) -> torch.device:
    """torch.device for an entry point's ``device`` argument; raises when
    CUDA is asked for and no card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["resolve_device", "device_const"]
