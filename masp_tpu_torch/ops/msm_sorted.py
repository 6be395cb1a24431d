"""Sorted-prefix Pippenger MSM, the projective scan path.

Port of masp_tpu/ops/msm_sorted.py as the prover runs it by default off the
batch-affine ladder (``window_buckets``, ``bucket_reduce_horner`` in its
sequential form, ``masked_sum``), with unsigned in-graph digits. Per c-bit
window:

1. sort the point indices by digit (stable: equal digits keep index order,
   as jax.lax.sort_key_val does, so the bucket limbs match the reference);
2. gather the points into sorted order as packed [X | Y | Z] rows;
3. build a dyadic prefix tree over the sorted points with a halving ladder
   of point adds (the leaf level in the Z in {0, mont-1} form);
4. read each bucket's sum as a difference of two exclusive-prefix queries at
   the bucket boundaries (searchsorted, right side);
5. weighted bucket reduction and Horner over windows.

Windows are independent, so every step runs all windows in one batch (one
kernel launch per ladder level), where the reference scans them in turn; the
arithmetic per window is the same, so are the limbs. Points are packed rows
(N, rowlen) int32: 72 limbs on G1, 144 on G2 (ops/weierstrass.rowlen).
"""

from __future__ import annotations

import numpy as np
import torch

from masp_tpu_torch import device_const
from masp_tpu_torch.kernels import point_add as PA
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops.field import FQ
from masp_tpu_torch.ops.msm import identity_rows


def n_windows_for(c: int) -> int:
    """Window count for 255-bit scalars: ceil(255 / c)."""
    if not 2 <= c <= 16:
        raise ValueError(f"window width out of range: {c}")
    return -(-255 // c)


def windows_from_limbs(limbs16, c: int):
    """(N, 16) canonical 16-bit Fr limbs -> (N, W) int64 unsigned c-bit
    window digits, W = n_windows_for(c)."""
    dev = limbs16.device

    def build():
        W_ = n_windows_for(c)
        idx = np.minimum(np.arange(W_) * c // 16, 15)
        # only bits < 256 are real; positions past limb 15 alias limb 15
        valid = np.clip(256 - np.arange(W_) * c, 0, c)
        return tuple(torch.as_tensor(x, device=dev) for x in (
            idx, np.minimum(idx + 1, 15), np.arange(W_) * c % 16, (1 << valid) - 1))

    lo_idx, hi_idx, off, wmask = device_const(("windows", c, dev), build)
    limbs = limbs16.to(torch.int64)
    pair = limbs[:, lo_idx] | (limbs[:, hi_idx] << 16)
    return (pair >> off[None, :]) & wmask[None, :]


def _g_neg(fops, rows):
    """Negate packed points: Y -> -Y (each Fq2 coefficient on G2)."""
    k = int(np.prod(fops.coord_shape))
    y = rows[..., k : 2 * k].reshape(rows.shape[:-1] + (-1, FQ.L))
    ny = F.neg(FQ, y).reshape(rows.shape[:-1] + (k,))
    return torch.cat([rows[..., :k], ny, rows[..., 2 * k :]], dim=-1)


def _add(fops, a, b, leaf01: bool = False):
    """Point-add kernel on packed rows of any matching leading shape."""
    lead = a.shape[:-1]
    out = PA.point_add(fops.GROUP, a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1]), leaf01)
    return out.reshape(lead + (a.shape[-1],))


def _halve(fops, cur, leaf01: bool):
    """One ladder level: rows (n, rowlen) -> sums of adjacent pairs (n/2, rowlen)."""
    rl = cur.shape[-1]
    pairs = cur.reshape(-1, 2 * rl)
    return PA.point_add(fops.GROUP, pairs[:, :rl], pairs[:, rl:], leaf01)


def window_buckets(fops, points_packed, digits, c: int):
    """Per-window bucket sums (W, B, rowlen), B = 2^c: the data-parallel bulk
    of the MSM. points_packed (N, rowlen) with N a power of two (pad with
    identity rows and zero digits); digits (N, W) unsigned."""
    N, rl = points_packed.shape
    n_windows = digits.shape[1]
    B = 1 << c
    levels = (N - 1).bit_length()
    if N != 1 << levels:
        raise ValueError("pad N to a power of two")
    dev = points_packed.device

    keys = digits.T.to(torch.int64).contiguous()  # (W, N)
    sorted_keys, perm = torch.sort(keys, dim=1, stable=True)
    kvals = torch.arange(B, dtype=torch.int64, device=dev).expand(n_windows, B).contiguous()
    # bounds[w, k] = #{digits[:, w] <= k}, the exclusive prefix boundary
    bounds = torch.searchsorted(sorted_keys, kvals, right=True)

    # up-sweep over all windows at once: nodes[l] holds, per window, the sums
    # of sorted points [j 2^l, (j+1) 2^l); pairs never straddle windows
    cur = points_packed[perm.reshape(-1)]  # (W*N, rowlen)
    nodes = [cur]
    for lv in range(levels):
        cur = _halve(fops, cur, leaf01=lv == 0)
        nodes.append(cur)

    # exclusive-prefix queries at the B bucket boundaries
    acc = identity_rows(fops, (n_windows, B), dev)
    wsel = torch.arange(n_windows, device=dev)[:, None]
    for lv in range(levels + 1):
        n_l = N >> lv
        idx = torch.clamp(2 * (bounds >> (lv + 1)), max=n_l - 1)
        bit = (bounds >> lv) & 1
        gath = nodes[lv].reshape(n_windows, n_l, rl)[wsel, idx]
        acc = torch.where(bit[..., None] != 0, _add(fops, acc, gath), acc)

    # bucket k = Q[k] - Q[k-1], Q[-1] = identity
    qprev = torch.cat([identity_rows(fops, (n_windows, 1), dev), acc[:, :-1]], dim=1)
    return _add(fops, acc, _g_neg(fops, qprev))


def bucket_reduce_horner(fops, buckets, c: int):
    """(Q, W, B, rowlen) bucket sums of Q independent MSMs -> (Q, rowlen).

    window[w] = sum_k k * bucket[w, k] by the running-suffix trick, then
    Horner over windows with c doublings between them. The Q MSMs share
    every launch; each one's arithmetic is what it would be alone."""
    Q, n_windows, B, rl = buckets.shape
    dev = buckets.device
    running = identity_rows(fops, (Q, n_windows), dev)
    acc = running
    for j in range(B - 1):
        k = B - 1 - j
        running = _add(fops, running, buckets[:, :, k])
        acc = _add(fops, acc, running)
    out = identity_rows(fops, (Q,), dev)
    for j in range(n_windows):
        out = _add(fops, out, acc[:, n_windows - 1 - j])
        if j < n_windows - 1:  # no doubling after the lowest window
            for _ in range(c):
                out = _add(fops, out, out)
    return out


def sorted_msm(fops, points_packed, digits, c: int):
    """sum_i [s_i] P_i as one projective row (rowlen,). points_packed
    (N, rowlen), N a power of two; digits (N, W) unsigned c-bit windows."""
    buckets = window_buckets(fops, points_packed, digits, c)
    return bucket_reduce_horner(fops, buckets[None], c)[0]


def sorted_msm_from_limbs(fops, points_packed, limbs16, c: int):
    """sorted_msm with digit extraction on the device from (N, 16)
    canonical 16-bit limb rows of the scalars."""
    return sorted_msm(fops, points_packed, windows_from_limbs(limbs16, c), c)


def masked_sum(fops, points_packed, bits):
    """sum_i [b_i] P_i for b_i in {0, 1}: identity where the bit is 0, then
    one halving ladder (N-1 adds; the leaf level in the Z in {0, mont-1}
    form). Returns one projective row (rowlen,)."""
    N = points_packed.shape[0]
    levels = (N - 1).bit_length()
    if N != 1 << levels:
        raise ValueError("pad N to a power of two")
    ident = identity_rows(fops, (N,), points_packed.device)
    cur = torch.where(bits.reshape(N, 1) != 0, points_packed, ident)
    for lv in range(levels):
        cur = _halve(fops, cur, leaf01=lv == 0)
    return cur[0]


__all__ = [
    "n_windows_for", "windows_from_limbs", "window_buckets",
    "bucket_reduce_horner", "sorted_msm", "sorted_msm_from_limbs",
    "masked_sum",
]
