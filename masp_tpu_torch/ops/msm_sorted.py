"""Sorted-prefix Pippenger MSM: the projective scan ladder (the default) and
the batch-affine ladder.

Port of masp_tpu/ops/msm_sorted.py as the prover runs it (``window_buckets``
and its flat form ``window_buckets_flat``, ``bucket_reduce_horner`` in its
sequential and wide forms, ``masked_sum``), with digits extracted on the
device, unsigned or balanced (``signed``: d in [-2^(c-1), 2^(c-1)], 2^(c-1) + 1
buckets, the points of negative digits entering the ladder negated).
Per c-bit window:

1. sort the point indices by digit (by |digit| when signed; stable: equal
   keys keep index order, as jax.lax.sort_key_val does, so the bucket limbs
   match the reference);
2. gather the points into sorted order as packed rows;
3. build a dyadic prefix tree over the sorted points with a halving ladder:
   with ``AFFINE_LADDER`` (the JAX package's accelerator default, off here), the
   lowest ``AFFINE_LEVELS`` levels as batch-affine adds over all windows at
   once (one batched inversion per level) and the levels above as
   projective adds; without it, projective adds throughout (the leaf level
   in the Z in {0, mont-1} form);
4. read each bucket's sum as a difference of two exclusive-prefix queries at
   the bucket boundaries (searchsorted, right side);
5. weighted bucket reduction (with the affine ladder a suffix scan and a
   halving ladder, else a running-sum chain) and Horner over windows.

Windows are independent, so every step runs all windows in one batch (one
kernel launch per ladder level), where the reference's scan path runs them in
turn; the arithmetic per window is the same, so are the limbs. Projective
points are packed rows (N, rowlen) int32: 72 limbs on G1, 144 on G2
(ops/weierstrass.rowlen); affine nodes are rows [x | y | f] of 2k + 1.

The two ladders give the same points but not the same projective limbs: an
affine node is the canonical affine sum, a projective node carries its own Z.

Off the prover's default route: ``sorted_msm_batch`` (Q independent MSMs
folded into the row axis, so that every ladder level and the reduction is
one launch over all Q) and the fixed-base BGMW tables for a parameter query
(``build_bgmw_table``, ``bgmw_msm_from_limbs``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from masp_tpu_torch import device_const
from masp_tpu_torch.kernels import affine as AK
from masp_tpu_torch.kernels import jubjub as KJ
from masp_tpu_torch.kernels import point_add as PA
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops.field import FQ
from masp_tpu_torch.ops.msm import identity_rows


def n_windows_for(c: int, signed: bool = False) -> int:
    """Window count for 255-bit scalars: ceil(255 / c), plus, when
    ``signed``, one all-carry window where the signed conversion's last
    carry would not fit the top window's headroom (its top digit plus the
    carry must stay <= 2^(c-1), so that it is never converted itself)."""
    if not 2 <= c <= 16:
        raise ValueError(f"window width out of range: {c}")
    W_ = -(-255 // c)
    if signed and (1 << (255 - c * (W_ - 1))) > (1 << (c - 1)):
        W_ += 1
    return W_


def windows_from_limbs(limbs16, c: int, signed: bool = False):
    """(N, 16) canonical 16-bit Fr limbs -> (N, W) int64 c-bit window
    digits, W = n_windows_for(c, signed). Unsigned digits lie in [0, 2^c);
    with ``signed`` they are carried into the balanced form in one pass over
    the windows, lowest first: a digit (plus the carry in) above 2^(c-1)
    becomes d - 2^c and carries 1 into the next window."""
    dev = limbs16.device

    def build():
        W_ = n_windows_for(c, signed)
        idx = np.minimum(np.arange(W_) * c // 16, 15)
        # only bits < 256 are real; positions past limb 15 alias limb 15
        valid = np.clip(256 - np.arange(W_) * c, 0, c)
        return tuple(torch.as_tensor(x, device=dev) for x in (
            idx, np.minimum(idx + 1, 15), np.arange(W_) * c % 16, (1 << valid) - 1))

    lo_idx, hi_idx, off, wmask = device_const(("windows", c, signed, dev), build)
    limbs = limbs16.to(torch.int64)
    pair = limbs[:, lo_idx] | (limbs[:, hi_idx] << 16)
    d = (pair >> off[None, :]) & wmask[None, :]
    if not signed:
        return d
    half = 1 << (c - 1)
    carry = torch.zeros_like(d[:, 0])
    cols = []
    for w in range(d.shape[1]):
        dw = d[:, w] + carry
        conv = dw > half
        cols.append(torch.where(conv, dw - (1 << c), dw))
        carry = conv.to(torch.int64)
    return torch.stack(cols, dim=1)


def n_buckets(c: int, signed: bool = False) -> int:
    """Buckets a window: 2^c, or 2^(c-1) + 1 for balanced digits (|d| keys)."""
    return (1 << (c - 1)) + 1 if signed else 1 << c


def _g_neg(fops, rows):
    """Negate packed points: Y -> -Y (each Fq2 coefficient on G2); a curve
    with a ``neg_point`` hook (Edwards: X -> -X) negates through it."""
    k = int(np.prod(fops.coord_shape))
    if hasattr(fops, "neg_point"):
        coords = tuple(rows[..., i * k : (i + 1) * k] for i in range(3))
        return torch.cat(fops.neg_point(coords), dim=-1)
    y = rows[..., k : 2 * k].reshape(rows.shape[:-1] + (-1, FQ.L))
    ny = F.neg(FQ, y).reshape(rows.shape[:-1] + (k,))
    return torch.cat([rows[..., :k], ny, rows[..., 2 * k :]], dim=-1)


def _add_rows(fops, a, b, leaf01: bool):
    """The add kernel of the curve on (n, rowlen) rows: the point-add kernel
    on G1 and G2, in its leaf form where ``leaf01``; a curve with an
    ``add_points`` hook (Jubjub) takes its own complete add, which has no
    leaf form, as the JAX package's g_add01 falls through to add_points."""
    if hasattr(fops, "add_points"):
        return KJ.jubjub_add(a, b)
    return PA.point_add(fops.GROUP, a, b, leaf01)


def _add(fops, a, b, leaf01: bool = False):
    """Point-add kernel on packed rows of any matching leading shape."""
    lead = a.shape[:-1]
    out = _add_rows(fops, a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1]), leaf01)
    return out.reshape(lead + (a.shape[-1],))


def _halve(fops, cur, leaf01: bool):
    """One ladder level: rows (n, rowlen) -> sums of adjacent pairs (n/2, rowlen)."""
    rl = cur.shape[-1]
    pairs = cur.reshape(-1, 2 * rl)
    return _add_rows(fops, pairs[:, :rl], pairs[:, rl:], leaf01)


def _levels(N: int) -> int:
    levels = (N - 1).bit_length()
    if N != 1 << levels:
        raise ValueError("pad N to a power of two")
    return levels


def _sorted_windows(digits, c: int, signed: bool = False):
    """perm (W, N): each window's point indices sorted by digit, by |digit|
    when ``signed`` (stable); bounds (W, B): bounds[w, k] = #{keys[:, w] <=
    k}, the exclusive prefix boundary of bucket k; signs (W, N), the sign of
    each sorted point's digit (True where negative), or None unsigned."""
    n_windows = digits.shape[1]
    B = n_buckets(c, signed)
    keys = digits.T.to(torch.int64).contiguous()  # (W, N)
    if signed:
        keys = keys.abs()
    sorted_keys, perm = torch.sort(keys, dim=1, stable=True)
    kvals = torch.arange(B, dtype=torch.int64, device=digits.device).expand(n_windows, B).contiguous()
    bounds = torch.searchsorted(sorted_keys, kvals, right=True)
    # the signs are indexed by original point: gather them through the
    # sorted permutation (the reference's flat ladder gathers them through its
    # storage order; the port stores the natural sorted order)
    signs = torch.gather(digits.T < 0, 1, perm) if signed else None
    return perm, bounds, signs


def _take(nodes, idx):
    """Rows at node indices idx (W, B) of one level's (W * n_l, r) rows."""
    n_windows = idx.shape[0]
    wsel = torch.arange(n_windows, device=idx.device)[:, None]
    return nodes.reshape(n_windows, -1, nodes.shape[-1])[wsel, idx]


def _bucket_sums(fops, gather, bounds, levels: int):
    """(W, B, rowlen) bucket sums from the prefix tree: exclusive-prefix
    queries at the bucket boundaries, then bucket k = Q[k] - Q[k-1] with
    Q[-1] = identity. ``gather(lv, idx)`` gives level lv's nodes at the
    (W, B) indices idx as projective rows."""
    n_windows, B = bounds.shape
    dev = bounds.device
    N = 1 << levels
    acc = identity_rows(fops, (n_windows, B), dev)
    for lv in range(levels + 1):
        idx = torch.clamp(2 * (bounds >> (lv + 1)), max=(N >> lv) - 1)
        bit = (bounds >> lv) & 1
        acc = torch.where(bit[..., None] != 0, _add(fops, acc, gather(lv, idx)), acc)
    qprev = torch.cat([identity_rows(fops, (n_windows, 1), dev), acc[:, :-1]], dim=1)
    return _add(fops, acc, _g_neg(fops, qprev))


def _fold_queries(points_packed, digits):
    """Q independent MSMs as one: (Q, N, rowlen) points and (Q, N, W) digits
    -> (Q N, rowlen) rows, (N, Q W) digits (window q W + w of point i is
    digits[q, i, w]) and the (Q W,) row offset q N of each window's points.
    (N, rowlen) points and (N, W) digits pass through with offset None."""
    if points_packed.dim() == 2:
        return points_packed, digits, None
    Q, N, rl = points_packed.shape
    n_windows = digits.shape[2]
    rows = points_packed.reshape(Q * N, rl)
    folded = digits.permute(1, 0, 2).reshape(N, Q * n_windows)
    base = torch.arange(Q, device=digits.device).repeat_interleave(n_windows) * N
    return rows, folded, base


def _sorted_rows(perm, base):
    """Row indices of the sorted points, (W N,): each window's permutation,
    offset into its own query's rows when Q MSMs are folded together."""
    return (perm if base is None else perm + base[:, None]).reshape(-1)


def _unfold_queries(buckets, points_packed):
    """(Q W, B, rowlen) bucket sums back to (Q, W, B, rowlen) for Q folded
    MSMs; (W, B, rowlen) as it is for one."""
    if points_packed.dim() == 2:
        return buckets
    return buckets.reshape((points_packed.shape[0], -1) + buckets.shape[1:])


def window_buckets(fops, points_packed, digits, c: int, signed: bool = False):
    """Per-window bucket sums (W, B, rowlen), B = n_buckets(c, signed): the
    data-parallel bulk of the MSM. points_packed (N, rowlen) with N a power
    of two (pad with identity rows and zero digits); digits (N, W), balanced
    when ``signed`` (the points of negative digits enter the ladder
    negated). Q independent MSMs, (Q, N, rowlen) points and (Q, N, W)
    digits, give (Q, W, B, rowlen): their Q W windows run as the windows of
    one MSM do, each over its own query's rows. With the affine ladder on
    this is ``window_buckets_flat``; else the projective scan ladder,
    nodes[l][j] = the sum of sorted points [j 2^l, (j+1) 2^l)."""
    if _affine_on(fops):
        return window_buckets_flat(fops, points_packed, digits, c, signed=signed)
    rows, folded, base = _fold_queries(points_packed, digits)
    levels = _levels(folded.shape[0])
    perm, bounds, signs = _sorted_windows(folded, c, signed)
    # up-sweep over all windows at once; pairs never straddle windows
    cur = rows[_sorted_rows(perm, base)]  # (W*N, rowlen)
    if signed:
        cur = torch.where(signs.reshape(-1, 1), _g_neg(fops, cur), cur)
    nodes = [cur]
    for lv in range(levels):
        cur = _halve(fops, cur, leaf01=lv == 0)
        nodes.append(cur)
    buckets = _bucket_sums(fops, lambda lv, idx: _take(nodes[lv], idx), bounds, levels)
    return _unfold_queries(buckets, points_packed)


def _window_sums_wide(fops, buckets):
    """(Q, W, B, rowlen) -> (Q, W, rowlen) sum_k k bucket[k]: a suffix scan
    along the bucket axis (log2 B steps), then sum_{j >= 1} S[j] by a
    halving ladder over the identity-padded suffixes."""
    Q, n_windows, B, rl = buckets.shape
    dev = buckets.device
    cur = buckets
    d = 1
    while d < B:
        shifted = torch.cat([cur[:, :, d:], identity_rows(fops, (Q, n_windows, d), dev)], dim=2)
        cur = _add(fops, cur, shifted)
        d *= 2
    Bp = 1 << (B - 2).bit_length() if B > 2 else 1
    cur = torch.cat([cur[:, :, 1:], identity_rows(fops, (Q, n_windows, Bp - (B - 1)), dev)], dim=2)
    while cur.shape[2] > 1:
        pairs = cur.reshape(Q, n_windows, -1, 2 * rl)
        cur = _add(fops, pairs[..., :rl], pairs[..., rl:])
    return cur[:, :, 0]


def bucket_reduce_horner(fops, buckets, c: int, wide: bool | None = None):
    """(Q, W, B, rowlen) bucket sums of Q independent MSMs -> (Q, rowlen).

    window[w] = sum_k k * bucket[w, k], by ``_window_sums_wide`` (log2(B)
    window-wide steps and a halving ladder) when ``wide``, else by the
    running-suffix chain (B - 1 dependent steps); then Horner over windows
    with c doublings between them. ``wide=None`` chooses as the reference
    does: the wide form with the affine ladder (the reference pairs the
    two), with MASP_MSM_WIDE_REDUCE=1, or from B >= 1024 buckets, on either
    ladder. Both forms give the same points. The Q MSMs share every launch;
    each one's arithmetic is what it would be alone."""
    Q, n_windows, B, rl = buckets.shape
    dev = buckets.device
    if wide is None:
        wide = _affine_on(fops) or WIDE_REDUCE or B >= 1024
    if wide:
        acc = _window_sums_wide(fops, buckets)
    else:
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


def sorted_msm(fops, points_packed, digits, c: int, signed: bool = False):
    """sum_i [s_i] P_i as one projective row (rowlen,). points_packed
    (N, rowlen), N a power of two; digits (N, W) c-bit windows, balanced
    when ``signed``."""
    buckets = window_buckets(fops, points_packed, digits, c, signed=signed)
    return bucket_reduce_horner(fops, buckets[None], c)[0]


def sorted_msm_from_limbs(fops, points_packed, limbs16, c: int, signed: bool = True):
    """sorted_msm with digit extraction on the device from (N, 16)
    canonical 16-bit limb rows of the scalars; balanced signed digits by
    default, as the reference's."""
    return sorted_msm(fops, points_packed, windows_from_limbs(limbs16, c, signed), c, signed=signed)


def sorted_msm_batch(fops, points_packed, digits, c: int, signed: bool = False):
    """Q independent MSMs: points_packed (Q, N, rowlen), digits (Q, N, W) ->
    (Q, rowlen) projective rows. The reference vmaps sorted_msm; here the Q
    queries fold into the row axis (``window_buckets`` on (Q, N, ...)), so
    each ladder level is one launch over all Q W windows and the reduction
    one launch a step over all Q, and each query's arithmetic is what it
    would be alone."""
    if points_packed.dim() != 3 or digits.dim() != 3 or digits.shape[:2] != points_packed.shape[:2]:
        raise ValueError(f"sorted_msm_batch takes (Q, N, rowlen) points and (Q, N, W) digits, got "
                         f"{tuple(points_packed.shape)} and {tuple(digits.shape)}")
    buckets = window_buckets(fops, points_packed, digits, c, signed=signed)
    return bucket_reduce_horner(fops, buckets, c)


def masked_sum(fops, points_packed, bits):
    """sum_i [b_i] P_i for b_i in {0, 1}: identity where the bit is 0, then
    one halving ladder (N-1 adds; the leaf level in the Z in {0, mont-1}
    form). Returns one projective row (rowlen,)."""
    N = points_packed.shape[0]
    levels = _levels(N)
    ident = identity_rows(fops, (N,), points_packed.device)
    cur = torch.where(bits.reshape(N, 1) != 0, points_packed, ident)
    for lv in range(levels):
        cur = _halve(fops, cur, leaf01=lv == 0)
    return cur[0]


# --- batch-affine ladder -------------------------------------------------------
#
# Within a ladder level every add is independent, so the lowest levels run
# in affine form with ONE batched inversion per level over all windows
# (product tree, ~3 products per lane, and one Fermat chain on the root):
# slope and x3/y3 cost 4 products per add on G1 against 12 for the complete
# projective add, with branch-free lanes for doubling, P + (-P) and the
# identity. G2 inverts the norms of its Fq2 denominators, so one Fq product
# tree serves both groups (kernels/affine.py). Level l holds N/2^l of the
# adds, so the savings halve per level while the root's Fermat chain stays;
# the levels above AFFINE_LEVELS are projective. Precondition: the rows are encoded affine points or identity
# pads (Z in {0, mont-1}), as the parameter queries are.
#
# Storage stays in natural sorted order at every level: level l + 1 pairs
# rows (2j, 2j + 1) of level l through even/odd views of one tensor, as the
# scan ladder does. The reference stores the affine levels partially
# bit-reversed (_sigma, _node_pos, _fold_halves*) so that its (L, B1, 128)
# TPU tiles fold contiguously; node j of level l is the same canonical
# affine sum in either storage, so the buckets come out with the same limbs.
#
# Off by default: on the H100 a Spend-shaped proof takes longer on this
# ladder than on the scan ladder, paced by the host's launches of the
# product trees' Montgomery products and by one dependent Fermat chain a
# level (PERF.md, sections 5 and 6).


def ladder_flags(env) -> tuple[bool, int]:
    """(AFFINE_LADDER, AFFINE_LEVELS) from the JAX package's variables:
    MASP_MSM_AFFINE "1" for the batch-affine ladder, "0" or "auto" (the
    default: the port's default, the scan ladder); MASP_MSM_AFFINE_LEVELS
    (4). A value this port does not implement raises. MASP_MSM_WIDE_REDUCE
    (WIDE_REDUCE) does not choose the ladder: it asks for the wide bucket
    reduction on either (``bucket_reduce_horner``)."""
    affine = env.get("MASP_MSM_AFFINE", "auto")
    if affine not in ("auto", "0", "1"):
        raise ValueError(f"MASP_MSM_AFFINE={affine!r}: the port takes auto, 0 or 1")
    affine = affine == "1"
    levels = int(env.get("MASP_MSM_AFFINE_LEVELS", "4"))
    if levels < 0:
        raise ValueError(f"MASP_MSM_AFFINE_LEVELS={levels} is negative")
    return affine, levels


AFFINE_LADDER, AFFINE_LEVELS = ladder_flags(os.environ)
# the wide bucket reduction on either ladder, as the reference reads it
WIDE_REDUCE = os.environ.get("MASP_MSM_WIDE_REDUCE", "0") == "1"


def affine_ladder_takes(n_windows: int, n_points: int) -> bool:
    """Whether the batch-affine ladder can run an MSM of this shape: its
    levels invert all windows' lanes with one product tree, so the lane
    count must be a power of two (c = 10, 12 or 13 give 26, 22 or 20
    windows, which it cannot take)."""
    lanes = n_windows * n_points
    return lanes & (lanes - 1) == 0


def _affine_on(fops) -> bool:
    """The affine ladder (and the wide reduction it pairs with) for the
    Weierstrass groups G1 and G2 while AFFINE_LADDER is set: the JAX
    package's default on its accelerator impl."""
    return bool(AFFINE_LADDER) and getattr(fops, "GROUP", None) in (1, 2)


def _affine_halve(rows):
    """One affine ladder level: (n, 2k+1) rows -> sums of adjacent pairs
    (n/2, 2k+1), one batched inversion over all of them, through the affine
    kernels on G1 and G2 alike."""
    r = rows.shape[-1]
    pairs = rows.reshape(-1, 2 * r)
    return AK.affine_level(pairs[:, :r], pairs[:, r:])


def _lift(fops, rows):
    """Affine rows [x | y | f] (..., 2k+1) -> projective rows [x | y | Z]
    with Z = f ? 0 : mont-1."""
    k = rows.shape[-1] // 2
    one = identity_rows(fops, (), rows.device)[k : 2 * k]  # the identity's Y is mont-1
    z = torch.where(rows[..., 2 * k :] != 0, torch.zeros_like(one), one)
    return torch.cat([rows[..., : 2 * k], z], dim=-1)


def window_buckets_flat(fops, points_packed, digits, c: int, signed: bool = False):
    """window_buckets on the batch-affine ladder: the lowest
    K = min(AFFINE_LEVELS, log2 N) levels affine over all windows' lanes at
    once, the levels above projective; the same prefix queries and bucket
    differences as the scan ladder, lifting the affine nodes' Z from their
    flags. With ``signed`` the gathered rows' y is negated where the digit
    is negative (x and the identity flag stay). Q folded MSMs as in
    ``window_buckets``. The affine levels need a power-of-two lane count
    W * N (ValueError otherwise: c = 10 or 11 gives 26 or 24 windows)."""
    rows, digits, base = _fold_queries(points_packed, digits)
    n_rows, rl = rows.shape
    N = digits.shape[0]
    n_windows = digits.shape[1]
    levels = _levels(N)
    K = max(0, min(AFFINE_LEVELS, levels))
    if K and not affine_ladder_takes(n_windows, N):
        raise ValueError(
            f"the batch-affine ladder needs a power-of-two lane count, got {n_windows} windows x "
            f"{N} points (c = {c}): choose c with a power-of-two window count or set AFFINE_LADDER = False")
    k = rl // 3
    perm, bounds, signs = _sorted_windows(digits, c, signed)
    # affine source rows [x | y | f], f = (Z == 0): the flag rides the row gather
    inf = fops.is_zero(rows[:, 2 * k :].reshape((n_rows,) + tuple(fops.coord_shape)))
    src = torch.cat([rows[:, : 2 * k], inf.to(torch.int32)[:, None]], dim=1)
    cur = src[_sorted_rows(perm, base)]  # (W*N, 2k+1)
    if signed:
        y = cur[:, k : 2 * k]
        ny = F.neg(FQ, y.reshape(-1, FQ.L)).reshape(y.shape)
        cur = torch.cat([cur[:, :k], torch.where(signs.reshape(-1, 1), ny, y), cur[:, 2 * k :]], dim=1)
    aff = [cur]
    for _ in range(K):
        cur = _affine_halve(cur)
        aff.append(cur)
    curp = _lift(fops, cur)
    proj = {K: curp}
    for lv in range(K, levels):
        curp = _halve(fops, curp, leaf01=False)
        proj[lv + 1] = curp

    def gather(lv, idx):
        return _lift(fops, _take(aff[lv], idx)) if lv <= K else _take(proj[lv], idx)

    return _unfold_queries(_bucket_sums(fops, gather, bounds, levels), points_packed)


# --- fixed-base (BGMW) tables ---------------------------------------------------
#
# Groth16's proving MSMs run over fixed parameter points, so the multiples
# [2^(c w)] P_i of every window w can be built once per parameters: the
# W-window Pippenger then becomes single-window MSMs over the (point,
# window) pairs, with no Horner chain, at a c above 8 (22 windows at
# c = 12, grouped [16, 4, 2]). Costs (W - 1) times the query's rows in
# device memory. G1 only, as the reference.


def _pow2_groups(w: int) -> list[int]:
    """A window count as descending powers of two (22 -> [16, 4, 2]): each
    group's merged MSM needs a power-of-two entry count for its ladder."""
    out = []
    bit = 1 << (w.bit_length() - 1)
    while w:
        if w >= bit:
            out.append(bit)
            w -= bit
        bit >>= 1
    return out


def build_bgmw_table(fops, points_packed, c: int):
    """The BGMW table of a G1 parameter query, (W N, rowlen) rows slab-major:
    slab w holds [2^(c w)] P_i, W = n_windows_for(c). Slab 0 is the query as
    it is (encoded affine points or identity pads); each further slab is c
    doublings of the one before, through the complete add ``g_add(p, p)``
    (one point-add launch each, both operands the same rows), and then all
    of them are made affine at once: one ``F.batch_mont_inv`` over every Z
    (the Fq product tree and one inversion at its root), x = X / Z, y = Y / Z,
    Z = mont-1, and identities (0, mont-1, 0). So every Z is 0 or mont-1, as
    the ladder's leaf add needs and the query's own rows have."""
    if getattr(fops, "GROUP", None) != 1:
        raise ValueError("BGMW tables are built for G1 queries only")
    n_windows = n_windows_for(c)
    N, rl = points_packed.shape
    k = rl // 3
    cur, slabs = points_packed, []
    for _ in range(n_windows - 1):
        for _ in range(c):
            cur = _add(fops, cur, cur)
        slabs.append(cur)
    proj = torch.cat(slabs)
    X, Y, Z = proj[:, :k], proj[:, k : 2 * k], proj[:, 2 * k :]
    zinv = F.batch_mont_inv(FQ, Z)
    ident = identity_rows(fops, (proj.shape[0],), proj.device)
    one = ident[:, k : 2 * k]  # the identity's Y is mont-1
    aff = torch.cat([F.mont_mul(FQ, X, zinv), F.mont_mul(FQ, Y, zinv), one], dim=1)
    aff = torch.where(fops.is_zero(Z)[:, None], ident, aff)
    return torch.cat([points_packed, aff])


def bgmw_msm_from_limbs(fops, table_rows, limbs16, c: int):
    """sum_i [s_i] P_i against a ``build_bgmw_table`` table, from (N, 16)
    canonical limb rows of the scalars: unsigned c-bit digits, then for each
    power-of-two group of g windows one single-window MSM over its g N
    (point, window) pairs at digits (g N, 1) (the slabs carry the window
    weights, so there are no Horner doublings; the reduction is the wide one
    from 1,024 buckets, as ``bucket_reduce_horner`` chooses), and the group
    results summed by one point add each. Returns one projective row."""
    N = limbs16.shape[0]
    digits = windows_from_limbs(limbs16, c)  # (N, W)
    n_windows = digits.shape[1]
    if table_rows.shape[0] != n_windows * N:
        raise ValueError(f"a table of {table_rows.shape[0]} rows for {n_windows} windows of {N} points")
    total, off = None, 0
    for g in _pow2_groups(n_windows):
        d = digits[:, off : off + g].T.reshape(g * N, 1)
        buckets = window_buckets(fops, table_rows[off * N : (off + g) * N], d, c)
        pt = bucket_reduce_horner(fops, buckets[None], c)[0]
        total = pt if total is None else _add(fops, total[None], pt[None])[0]
        off += g
    return total


__all__ = [
    "n_windows_for", "n_buckets", "windows_from_limbs", "window_buckets", "window_buckets_flat",
    "bucket_reduce_horner", "sorted_msm", "sorted_msm_from_limbs", "sorted_msm_batch",
    "build_bgmw_table", "bgmw_msm_from_limbs", "masked_sum", "affine_ladder_takes", "ladder_flags", "AFFINE_LADDER", "AFFINE_LEVELS",
]
