"""Fixed-base scalar multiplication and shared MSM helpers.

Port of masp_tpu/ops/msm.py: the identity rows, host digit extraction,
the device byte digits of Fr values (``fr_digits_device``), the windowed
fixed-base table and ``fixed_base_scalarmuls`` (windowed table gathers plus
one point-add kernel launch per window), and the lane-private Pippenger
(``pippenger_msm``, with its host helper ``pad_points_for_msm``), which the
sharded Pippenger of parallel/mesh.py runs on each shard. The prover uses the
sorted MSM (ops/msm_sorted.py).
"""

from __future__ import annotations

import numpy as np
import torch

from masp_tpu_torch import device_const
from masp_tpu_torch.kernels import point_add as PA
from masp_tpu_torch.ops import weierstrass as W
from masp_tpu_torch.ops.field import FQ


def identity_rows(fops, batch_shape, device) -> torch.Tensor:
    """Packed identity rows of shape batch_shape + (rowlen,): (0 : 1 : 0) on
    G1 and G2; a curve with another identity declares it as an
    ``IDENTITY_MONT`` tuple of coordinates (Jubjub: (0 : 1 : 1) over Fr)."""
    k = int(np.prod(fops.coord_shape))
    ident = getattr(fops, "IDENTITY_MONT", None)

    def build():
        if ident is not None:
            row = np.concatenate([np.asarray(c).reshape(-1) for c in ident]).astype(np.int32)
        else:
            row = np.zeros(3 * k, dtype=np.int32)
            row[k : k + FQ.L] = FQ.ONE_MONT
        return torch.as_tensor(row, device=device)

    curve = "weierstrass" if ident is None else fops.__name__
    row = device_const(("identity_row", curve, k, torch.device(device)), build)
    return row.expand(tuple(batch_shape) + (3 * k,)).clone()


def scalars_to_digits(scalars: list[int], c: int, num_bits: int = 255) -> np.ndarray:
    """[N] ints -> (N, W) int32 window digits, W = ceil(num_bits / c)."""
    n_windows = -(-num_bits // c)
    if c == 8:  # digits are bytes
        nbytes = -(-num_bits // 8)
        buf = b"".join(int(s).to_bytes(nbytes, "little") for s in scalars)
        arr = np.frombuffer(buf, dtype=np.uint8).reshape(len(scalars), nbytes)
        return arr[:, :n_windows].astype(np.int32)
    out = np.zeros((len(scalars), n_windows), dtype=np.int32)
    mask = (1 << c) - 1
    for i, s in enumerate(scalars):
        for w in range(n_windows):
            out[i, w] = (s >> (c * w)) & mask
    return out


def fr_digits_device(x_mont):
    """Montgomery Fr limbs (N, 16) -> (N, 32) int64 byte digits (c = 8) of
    the canonical values, on the limbs' device: no host round trip for an
    NTT's output."""
    from masp_tpu_torch.ops import field as F

    canon = F.from_mont(F.FR, x_mont).to(torch.int64)  # canonical 16-bit limbs
    return torch.stack([canon & 0xFF, canon >> 8], dim=-1).reshape(canon.shape[0], 32)


def fixed_base_table(base, c: int = 8, num_bits: int = 256):
    """Host: windowed table T[w][k] = [k * 2^(c*w)] base (affine host
    points). Returns the nested list; encode with the caller's codec."""
    n_windows = -(-num_bits // c)
    table = []
    g = base
    for _w in range(n_windows):
        row = [type(base).identity()]
        acc = type(base).identity()
        for _k in range(1, 1 << c):
            acc = acc + g
            row.append(acc)
        table.append(row)
        for _ in range(c):
            g = g.double()
    return table


def encode_table(fops, table, device) -> torch.Tensor:
    """Nested host table -> (W, 2^c, rowlen) packed rows on device."""
    enc = W.encode_g1_points if fops.GROUP == 1 else W.encode_g2_points
    rows = []
    for row in table:
        coords = enc(row)
        rows.append(np.concatenate([c.reshape(len(row), -1) for c in coords], axis=1))
    return torch.as_tensor(np.stack(rows).astype(np.int32), device=device)


def fixed_base_scalarmuls(fops, table_rows, digits):
    """[s_i] G for each scalar; table_rows (W, 2^c, rowlen) packed rows,
    digits (N, W) int64 tensor. Returns per-scalar projective rows (N, rowlen)."""
    n_windows = table_rows.shape[0]
    acc = identity_rows(fops, (digits.shape[0],), table_rows.device)
    for w in range(n_windows):
        acc = PA.point_add(fops.GROUP, acc, table_rows[w][digits[:, w]])
    return acc


# --- variable-base Pippenger -------------------------------------------------------

def pippenger_msm(fops, points_xyz, digits, c: int, lanes: int = 64):
    """sum_i [s_i] P_i by lane-private buckets.

    points_xyz: the (X, Y, Z) coordinate tensors (N, ...) of
    ops/weierstrass.py; digits (N, W) c-bit windows (``scalars_to_digits``).
    N must be a multiple of ``lanes`` (pad with identities and zero digits:
    ``pad_points_for_msm``). Each of the lanes owns a (W, 2^c) bucket
    array; step s gathers, for every (lane, window), the bucket at the
    digit of the lane's s-th point, adds the point to it in one group add
    over lanes x W rows, and writes the rows back (no two (lane, window)
    pairs collide within a step, so the writes need no accumulation). Then
    the lanes combine in turn, the buckets reduce by the running suffix and
    the windows by Horner with c doublings a window, the last undoubled
    (``msm_sorted.bucket_reduce_horner``'s sequential form: the same adds in
    the same order). Returns one projective point as coordinates without a
    batch axis."""
    from masp_tpu_torch.ops import msm_sorted as MS

    N = points_xyz[0].shape[0]
    if N % lanes:
        raise ValueError(f"pad N to a multiple of lanes: {N} points, {lanes} lanes")
    n_windows = digits.shape[1]
    B = 1 << c
    dev = points_xyz[0].device
    rows = torch.cat([x.reshape(N, -1) for x in points_xyz], dim=1).to(torch.int32)
    rl = rows.shape[1]
    state = identity_rows(fops, (lanes, n_windows, B), dev)
    lane_idx = torch.arange(lanes, device=dev)[:, None].expand(lanes, n_windows)
    win_idx = torch.arange(n_windows, device=dev)[None, :].expand(lanes, n_windows)
    d_steps = digits.to(device=dev, dtype=torch.int64).reshape(N // lanes, lanes, n_windows)
    for s in range(N // lanes):
        d = d_steps[s]
        pts = rows[s * lanes : (s + 1) * lanes, None, :].expand(lanes, n_windows, rl)
        new = MS._add(fops, state[lane_idx, win_idx, d], pts)
        state.index_put_((lane_idx, win_idx, d), new)
    acc = identity_rows(fops, (n_windows, B), dev)
    for p in range(lanes):
        acc = MS._add(fops, acc, state[p])
    out = MS.bucket_reduce_horner(fops, acc[None], c, wide=False)[0]
    k = rl // 3
    return tuple(out[i * k : (i + 1) * k].reshape(fops.coord_shape) for i in range(3))


def pad_points_for_msm(fops, encode_fn, points, scalars, lanes: int, c: int, num_bits: int = 255):
    """Host helper: encode points and digits padded to a lane multiple."""
    n = len(points)
    pad = (-n) % lanes
    if pad:
        ident = type(points[0]).identity()
        points = list(points) + [ident] * pad
        scalars = list(scalars) + [0] * pad
    coords = encode_fn(points)
    digits = scalars_to_digits(scalars, c, num_bits)
    return coords, digits


__all__ = ["identity_rows", "scalars_to_digits", "fr_digits_device", "fixed_base_table",
           "encode_table", "fixed_base_scalarmuls", "pippenger_msm", "pad_points_for_msm"]
