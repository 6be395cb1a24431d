"""Montgomery product with both reductions as constant-matrix products
(the tensor-core Montgomery experiment).

Replaces the Pallas kernel ``_mont_mxu_kernel`` (tools/exp_mxu_mont.py:191)
and its row function ``rows_mont_mul_mxu`` (:99). Of CIOS's multiply-adds,
half multiply by fixed constants: m = T_lo N' mod 2^384 and m N. Over 8-bit
chunks each is a Toeplitz matrix times the batch, which a matrix unit can
carry. The CUDA kernel is ``csrc/mont_mul_mxu.cu`` (Fq only): the schoolbook
T = a b on the integer units, the two products on the tensor cores.

``mxu_consts`` is the port's copy of the reference's ``_mxu_consts``: the
recentred int8 matrices (chunk - 128) with their band matrices and constant
vectors, as the TPU's signed-only int8 unit needed them. The plain version
``mont_mul_mxu_plain`` follows ``rows_mont_mul_mxu`` step by step with them.
Hopper's IMMA takes unsigned bytes, so the kernel multiplies the plain
Toeplitz bytes instead, ``(M + 128) * B``: the same lazy columns.

Like the reference, the top carry of (T + m N) is dropped, so the limbs
equal ``mont_mul``'s for inputs below N; other 16-bit limbs (the timing
inputs) give some result, the same in the kernel and the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from masp_tpu_torch import device_const
from masp_tpu_torch.kernels import count_launch
from masp_tpu_torch.kernels import mont_mul as MK
from masp_tpu_torch.kernels.build import library
from masp_tpu_torch.ops.limbs import exact_matmul, normalize, reduce_once

CONST_KEYS = ("M1t", "B1", "C1", "M2t", "B2", "C2")


def mxu_consts(spec) -> dict:
    """The reductions' constant matrices as numpy arrays: M1t, B1 (2L, 2L)
    int8, C1 (2L, 1) int32, M2t, B2 (4L, 2L) int8, C2 (4L, 1) int32, where
    M is the recentred Toeplitz matrix of N' (dot 1) or N (dot 2), B its
    0/1 band and C the constant that the recentring leaves."""
    L8 = 2 * spec.L

    def chunks8(x, n):
        return [(x >> (8 * i)) & 0xFF for i in range(n)]

    np8, n8 = chunks8(spec.n_prime, L8), chunks8(spec.modulus, L8)
    # dot 1: m_lazy[k] = sum_{i+j=k, k<48} t8[i] np8[j] = M1t t8c + 128 B1 t8c + C1[k]
    M1t = np.zeros((L8, L8), dtype=np.int64)
    B1 = np.zeros((L8, L8), dtype=np.int64)
    C1 = np.zeros((L8,), dtype=np.int64)
    for k in range(L8):
        for i in range(k + 1):
            M1t[k, i] = np8[k - i] - 128
            B1[k, i] = 1
            C1[k] += 128 * (np8[k - i] - 128) + 128 * 128
    # dot 2: mn_lazy[k] = sum_{i+j=k, i,j<48} m8[i] n8[j], k < 96
    M2t = np.zeros((2 * L8, L8), dtype=np.int64)
    B2 = np.zeros((2 * L8, L8), dtype=np.int64)
    C2 = np.zeros((2 * L8,), dtype=np.int64)
    for k in range(2 * L8):
        for i in range(L8):
            if 0 <= k - i < L8:
                M2t[k, i] = n8[k - i] - 128
                B2[k, i] = 1
                C2[k] += 128 * (n8[k - i] - 128) + 128 * 128
    return {
        "M1t": M1t.astype(np.int8), "B1": B1.astype(np.int8), "C1": C1.astype(np.int32).reshape(-1, 1),
        "M2t": M2t.astype(np.int8), "B2": B2.astype(np.int8), "C2": C2.astype(np.int32).reshape(-1, 1),
    }


def _consts_on(spec, device):
    """The constants as int64 tensors on a device, made once."""
    def build():
        return {k: torch.as_tensor(v.astype(np.int64), device=device) for k, v in mxu_consts(spec).items()}

    return device_const(("mxu", spec.name, device), build)


def _chain8(v):
    """Lazy columns (n, K) int64 >= 0 -> K 8-bit chunks (n, K) and the carry
    out of the top chunk, by the reference's sequential carry chain."""
    out = torch.empty_like(v)
    c = torch.zeros_like(v[:, 0])
    for k in range(v.shape[1]):
        s = v[:, k] + c
        out[:, k] = s & 0xFF
        c = s >> 8
    return out, c


def _bytes_of(limbs16):
    """(n, L) 16-bit limbs -> (n, 2L) 8-bit chunks, low byte first."""
    return torch.stack([limbs16 & 0xFF, limbs16 >> 8], dim=2).reshape(limbs16.shape[0], -1)


def _lazy_dot(chunks, M, B, C):
    """The reference's dot on recentred chunks: M c + 128 B c + C, rows as
    the batch: (n, K) chunks -> (n, rows of M) int64."""
    cc = chunks - 128
    return exact_matmul(cc, M.T) + 128 * exact_matmul(cc, B.T) + C.T


def mont_mul_mxu_plain(spec, a, b):
    """Plain PyTorch version of ``rows_mont_mul_mxu`` on (n, L) int limb
    rows; returns (n, L) int32.

    The schoolbook product and the 2L 16-bit limbs of T; the recentred
    8-bit chunks of T_lo and m_lazy = M1t t + 128 B1 t + C1; the 8-bit
    chain to the 2L chunks of m mod 2^(16 L); mn_lazy the same way from
    M2t, B2, C2; the chain over the low 2L positions for its carry, the
    chain over the high 2L positions folded to 16-bit limbs (the top carry
    dropped); one conditional subtraction of N."""
    L = spec.L
    n = a.shape[0]
    dev = a.device
    k = _consts_on(spec, dev)
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    spread = device_const(("S", L, dev), lambda: MK._spread(L, dev))
    T, _ = normalize(exact_matmul((a64[:, :, None] * b64[:, None, :]).reshape(n, L * L), spread))
    t8 = _bytes_of(T)  # (n, 4L): chunks of all of T
    m8, _ = _chain8(_lazy_dot(t8[:, : 2 * L], k["M1t"], k["B1"], k["C1"]))
    mn = _lazy_dot(m8, k["M2t"], k["B2"], k["C2"])
    c = torch.zeros(n, dtype=torch.int64, device=dev)
    for j in range(2 * L):
        c = (mn[:, j] + t8[:, j] + c) >> 8
    hi8 = mn[:, 2 * L :] + t8[:, 2 * L :]
    hi8[:, 0] += c
    hi8, _ = _chain8(hi8)
    out16 = hi8[:, 0::2] | (hi8[:, 1::2] << 8)
    return reduce_once(spec.const("N", dev), out16, torch.zeros_like(c)).to(torch.int32)


# --- the CUDA kernel's wrapper ---------------------------------------------------

def band_blocks(rows: int) -> list[tuple[int, int]]:
    """The (m-tile, k step) blocks of 16 rows and 32 byte columns that the
    band of a (rows, 48) Toeplitz matrix (A[k][i] != 0 only for 0 <= k - i
    <= 47) meets, the depth padded to 64: the blocks the kernel multiplies,
    in its order (csrc/mont_mul_mxu.cu's band and block_index)."""
    return [(mt, ks) for mt in range(rows // 16) for ks in range(2)
            if 32 * ks <= 16 * mt + 15 and 16 * mt <= min(32 * ks + 31, 47) + 47]


def fragments(A: np.ndarray) -> np.ndarray:
    """mma.sync m16n8k32 A fragments of a (16 MT, 48) uint8 matrix, its
    depth zero-padded to 64, as the kernel reads them: uint32 (blocks, 32,
    4), [block of band_blocks, lane, reg]. Lane l = 4 g + t of block (mt,
    ks) holds bytes 32 ks + 4 t .. + 3 of row 16 mt + g (reg 0) and of row
    16 mt + g + 8 (reg 1), and bytes 32 ks + 16 + 4 t .. + 3 of the same
    rows (regs 2, 3), little-endian in each word."""
    rows, depth = A.shape
    padded = np.zeros((rows, 64), dtype=np.uint8)
    padded[:, :depth] = A.astype(np.uint8)
    words = padded.view("<u4").reshape(rows, 16)
    blocks = np.array(band_blocks(rows))
    mt, ks = blocks[:, 0, None, None], blocks[:, 1, None, None]
    lane = np.arange(32)[None, :, None]
    reg = np.arange(4)[None, None, :]
    return words[16 * mt + lane // 4 + 8 * (reg % 2), 8 * ks + lane % 4 + 4 * (reg // 2)]


def unsigned_toeplitz(consts: dict) -> tuple[np.ndarray, np.ndarray]:
    """The plain byte Toeplitz matrices (M + 128) B of the two dots, uint8."""
    return tuple(((consts[m].astype(np.int64) + 128) * consts[bm]).astype(np.uint8)
                 for m, bm in (("M1t", "B1"), ("M2t", "B2")))


def _frag_tensors(spec, device):
    def build():
        return tuple(torch.as_tensor(fragments(A).view(np.int32), device=device)
                     for A in unsigned_toeplitz(mxu_consts(spec)))

    return device_const(("mxu_frag", spec.name, device), build)


@functools.cache
def _c_fn():
    fn = library("mont_mul_mxu").masp_mont_mul_mxu
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def mont_mul_mxu(spec, a, b):
    """a*b*R^-1 mod N on (n, L) int32 limb rows, the reductions as
    constant-matrix products; limbs equal ``mont_mul``'s for inputs below N.
    A CPU tensor runs the plain version; a CUDA tensor launches the kernel
    (Fq only) or raises."""
    if a.dtype != torch.int32 or b.dtype != torch.int32:
        raise TypeError("mont_mul_mxu takes int32 limb tensors")
    if a.dim() != 2 or a.shape[1] != spec.L or a.shape != b.shape:
        raise ValueError(f"mont_mul_mxu takes two (n, {spec.L}) tensors, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("mont_mul_mxu operands on different devices")
    if a.device.type == "cpu":
        return mont_mul_mxu_plain(spec, a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if spec.name != "Fq":
        raise ValueError(f"the mont_mul_mxu kernel is for Fq, got {spec.name}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("mont_mul_mxu takes contiguous tensors")
    out = torch.empty_like(a)
    n = a.shape[0]
    if n == 0:
        return out
    f1, f2 = _frag_tensors(spec, a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _c_fn()(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, f1.data_ptr(), f2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"mont_mul_mxu kernel launch failed: CUDA error {err}")
    count_launch("mont_mul_mxu")
    return out


__all__ = ["mxu_consts", "mont_mul_mxu", "mont_mul_mxu_plain", "fragments", "band_blocks", "unsigned_toeplitz",
           "CONST_KEYS"]
