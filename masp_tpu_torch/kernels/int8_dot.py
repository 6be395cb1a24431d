"""Int8 x int8 -> int32 matrix products: one product, and the sum of
``reps`` identical products inside one launch (a throughput probe).

Replaces the Pallas kernels ``dot_kernel`` (tools/bench_kernel_micro.py:129)
and ``mm_loop_kernel`` (:154), which the kernel microbenchmark uses to probe
the TPU's matrix unit. The CUDA kernels are in ``csrc/int8_dot.cu``, K <= 64.
The single product (warp-level mma.sync) fills the card with one warp per
16 x 32 output tile and loads its operands in words and 16-byte chunks. The
loop (warpgroup-level wgmma m64n24k32) stages a 64-row tile of x and 24
columns of w once, in the canonical K-major layout that wgmma's shared-memory
descriptors read, splits the reps over a cluster of CLUSTER CTAs per tile and
sums their partial tiles through distributed shared memory. The functions
below the wrappers model that layout, its descriptors, the accumulator's
fragment and the rep split on the host, for the CPU tests; the ``.cu``
mirrors their constants. The plain versions compute the same integers as
float64 products (``ops/limbs.exact_matmul``), exact because every sum is an
integer below 2^53 (K 128^2 for K <= 2^39).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from masp_tpu_torch.kernels import count_launch
from masp_tpu_torch.kernels.build import library
from masp_tpu_torch.ops.limbs import exact_matmul

K_MAX = 64

# int8_dot_loop_kernel's tiles and layout (csrc/int8_dot.cu, same names)
LOOP_TILE_M = 64  # rows of x a CTA: wgmma's m64
LOOP_TILE_N = 24  # columns of w a CTA: wgmma's n24
K_PAD = 64  # depth staged, zero past K: two k32 steps
K_STEP = 32  # wgmma's depth for 8-bit operands
CLUSTER = 2  # CTAs of one output tile, one rep slice each
LBO = 128  # bytes from a core matrix (8 rows x 16 bytes) to the next along K
SBO = 512  # bytes from 8 rows to the next 8
SWIZZLE = 0  # the descriptor's layout type: no swizzle
PART_STRIDE = 40  # int32 words a row of a CTA's partial tile


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


# --- int8_dot_loop_kernel's layout, modelled on the host ----------------------

def rep_slices(reps: int, slices: int = CLUSTER) -> list[int]:
    """The reps each slice runs: slice i (cluster rank i) takes
    reps // slices, one more when i < reps % slices."""
    return [reps // slices + (i < reps % slices) for i in range(slices)]


def staged_offset(row: int, k: int) -> int:
    """Byte (row, k) of a staged K-major operand (``staged`` in the .cu):
    core matrices of 8 rows x 16 bytes, 128 contiguous bytes each."""
    return (row // 8) * SBO + (k // 16) * LBO + (row % 8) * 16 + k % 16


def stage_x(x, row0: int = 0):
    """The staged bytes of x's tile at row0, as the kernel stores them:
    16-byte chunks (row, 16 kc) of x, zero past x's rows and depth."""
    import numpy as np

    M, K = x.shape
    buf = np.zeros(LOOP_TILE_M * K_PAD, dtype=np.int8)
    for c in range(LOOP_TILE_M * K_PAD // 16):
        r, kc = divmod(c, K_PAD // 16)
        chunk = np.zeros(16, dtype=np.int8)
        if row0 + r < M:
            part = x[row0 + r, 16 * kc : min(16 * kc + 16, K)]
            chunk[: len(part)] = part
        off = staged_offset(r, 16 * kc)
        buf[off : off + 16] = chunk
    return buf


def stage_wt(w, col0: int = 0):
    """The staged bytes of w's LOOP_TILE_N columns from col0, transposed,
    as the kernel stores them: words of 4 consecutive k of one column (the
    task of k group kg and column chunk cc loads rows 4 kg .. 4 kg + 3, 8
    columns, and transposes them), zero past w's depth and columns."""
    import numpy as np

    K, N = w.shape
    pad = np.zeros((K_PAD, LOOP_TILE_N), dtype=np.int8)
    cols = w[:, col0 : col0 + LOOP_TILE_N]
    pad[:K, : cols.shape[1]] = cols
    buf = np.zeros(LOOP_TILE_N * K_PAD, dtype=np.int8)
    for kg in range(K_PAD // 4):
        for n in range(LOOP_TILE_N):
            off = staged_offset(n, 4 * kg)
            buf[off : off + 4] = pad[4 * kg : 4 * kg + 4, n]
    return buf


def smem_desc(addr: int) -> int:
    """wgmma's 64-bit shared-memory matrix descriptor (``smem_desc``): start
    address >> 4 in bits 0-13, LBO >> 4 in 16-29, SBO >> 4 in 32-45, the
    layout type in 62-63."""
    return ((addr & 0x3FFFF) >> 4) | (LBO >> 4) << 16 | (SBO >> 4) << 32 | SWIZZLE << 62


DESC_K_STEP = (K_STEP // 16) * LBO >> 4  # a k32 step further along K, in descriptor units


def acc_position(warp: int, lane: int, i: int) -> tuple[int, int]:
    """(row, column) of accumulator register i of a thread (warp of its
    warpgroup, lane) in wgmma m64nNk32's s32 fragment: n-tile i // 4 of 8
    columns, rows g and g + 8 of the warp's 16 (g = lane // 4), columns
    2 (lane % 4) and the next."""
    g, t = divmod(lane, 4)
    return 16 * warp + g + 8 * (i // 2 % 2), 8 * (i // 4) + 2 * t + i % 2


def a_position(warp: int, lane: int, reg: int, byte: int) -> tuple[int, int]:
    """(row, k within the k32 step) of byte ``byte`` of A-fragment register
    ``reg`` in wgmma m64nNk32's 8-bit register form."""
    g, t = divmod(lane, 4)
    return 16 * warp + g + 8 * (reg % 2), 16 * (reg // 2) + 4 * t + byte


def epilogue_pairs(warp: int, lane: int):
    """(row, column, register) of each 8-byte store of a thread's
    accumulator into its CTA's partial tile: registers 2p and 2p + 1."""
    g, t = divmod(lane, 4)
    return [(16 * warp + g + 8 * (p % 2), 8 * (p // 2) + 2 * t, 2 * p) for p in range(LOOP_TILE_N // 4)]


def band_chunks(rank: int):
    """(row, column) of each 16-byte chunk that cluster rank ``rank`` sums
    over the cluster's partial tiles and writes: its band of
    LOOP_TILE_M / CLUSTER rows."""
    band, rc = LOOP_TILE_M // CLUSTER, LOOP_TILE_N // 4
    return [(rank * band + c // rc, 4 * (c % rc)) for c in range(band * rc)]


__all__ = ["int8_dot", "int8_dot_loop", "int8_dot_plain", "int8_dot_loop_plain", "rep_slices"]
