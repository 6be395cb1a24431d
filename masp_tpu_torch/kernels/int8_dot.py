"""Int8 x int8 -> int32 matrix products: one product, and the sum of
``reps`` identical products inside one launch (a throughput probe).

Replaces the Pallas kernels ``dot_kernel`` (tools/bench_kernel_micro.py:129)
and ``mm_loop_kernel`` (:154), which the kernel microbenchmark uses to probe
the TPU's matrix unit. The CUDA kernels are in ``csrc/int8_dot.cu``
(warp-level IMMA, K <= 64): the single product fills the card with one warp
per 16 x 32 output tile and loads its operands in words and 16-byte chunks;
the loop stages both operands byte by byte for a block of four warps. The
plain versions compute the same integers as float64 products
(``ops/limbs.exact_matmul``), exact because every sum is an integer below
2^53 (K 128^2 for K <= 2^39).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from masp_tpu_torch.kernels import count_launch
from masp_tpu_torch.kernels.build import library
from masp_tpu_torch.ops.limbs import exact_matmul

K_MAX = 64


def int8_dot_plain(x, w):
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact."""
    return exact_matmul(x, w).to(torch.int32)


def int8_dot_loop_plain(x, w, reps: int):
    """The sum of ``reps`` products x @ w, as int32 (wrapping as the
    kernel's int32 accumulator does)."""
    return (reps * exact_matmul(x, w)).to(torch.int32)


# --- the CUDA kernel's wrappers ------------------------------------------------

@functools.cache
def _c_fn(loop: bool):
    """masp_int8_dot(x, w, out, M, K, N, stream) or
    masp_int8_dot_loop(x, w, out, M, K, N, reps, stream)."""
    lib = library("int8_dot")
    fn = lib.masp_int8_dot_loop if loop else lib.masp_int8_dot
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (4 if loop else 3) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, w) -> bool:
    """Shapes and types; True when the plain version runs (CPU tensors)."""
    if x.dtype != torch.int8 or w.dtype != torch.int8 or x.dim() != 2 or w.dim() != 2:
        raise TypeError(f"int8_dot takes two 2-D int8 tensors, got {x.dtype} {tuple(x.shape)}, "
                        f"{w.dtype} {tuple(w.shape)}")
    if x.shape[1] != w.shape[0]:
        raise ValueError(f"int8_dot: inner dimensions differ, {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.device != w.device:
        raise ValueError("int8_dot operands on different devices")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not 1 <= x.shape[1] <= K_MAX:
        raise ValueError(f"the int8_dot kernel takes 1 <= K <= {K_MAX}, got {x.shape[1]}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("int8_dot takes contiguous tensors")
    return False


def _launch(name, x, w, *reps):
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.int32, device=x.device)
    if M == 0 or N == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _c_fn(bool(reps))(x.data_ptr(), w.data_ptr(), out.data_ptr(), M, K, N, *reps, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    count_launch(name)
    return out


def int8_dot(x, w):
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32. A CPU tensor runs the
    plain version; a CUDA tensor launches the kernel or raises."""
    if _check(x, w):
        return int8_dot_plain(x, w)
    return _launch("int8_dot", x, w)


def int8_dot_loop(x, w, reps: int):
    """The sum of ``reps`` products x @ w computed inside one launch. A CPU
    tensor runs the plain version; a CUDA tensor launches the kernel or
    raises."""
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    if _check(x, w):
        return int8_dot_loop_plain(x, w, reps)
    return _launch("int8_dot_loop", x, w, int(reps))


__all__ = ["int8_dot", "int8_dot_loop", "int8_dot_plain", "int8_dot_loop_plain"]
