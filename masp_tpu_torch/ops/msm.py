"""Fixed-base scalar multiplication and shared MSM helpers.

Port of the parts of masp_tpu/ops/msm.py that the prover and the parameter
generator use: the identity rows, host digit extraction, the windowed
fixed-base table and ``fixed_base_scalarmuls`` (windowed table gathers plus
one point-add kernel launch per window). The lane-private Pippenger of that
module is not ported: the prover uses the sorted MSM (ops/msm_sorted.py).
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


__all__ = ["identity_rows", "scalars_to_digits", "fixed_base_table",
           "encode_table", "fixed_base_scalarmuls"]
