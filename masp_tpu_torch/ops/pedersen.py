"""Batched Pedersen hashing on the device (Jubjub, signed-digit chunk tables).

Port of masp_tpu/ops/pedersen_jax.py, for bulk Merkle-tree construction and
batched note commitments. Every 3-bit chunk j of generator segment s adds
d 2^(4j) G_s with digit d = (1 + a + 2b)(1 - 2c) in {±1 .. ±4}. One table
holds, per chunk position, the nine points of d = -4 .. 4 (d = 0 the
identity, used for padding), so a batch of N hashes is numpy bit-to-digit
extraction on the host and one launch of the fold kernel
(kernels/jubjub.pedersen_fold): a group of threads a hash adds its C chunk
points from the identity in chunk order, as the JAX package's fori_loop
does, which gives the same projective limbs (a tree fold would give the same
points under other Z). About C adds a hash, 172 for a Merkle node: mixed
adds, since every table entry has Z = 1 (the kernel reads the table in its
own layout, kernels/jubjub.fold_table, made once per table).

Entry points take ``device`` ("cuda" by default; the tests pass "cpu"); the
chunk table is cached on the device per chunk count.
"""

from __future__ import annotations

import logging
import time
from functools import lru_cache

import numpy as np
import torch

from masp_tpu_torch import device_const, resolve_device
from masp_tpu_torch.host.jubjub import ExtendedPoint
from masp_tpu_torch.host.primitives.constants import (
    PEDERSEN_HASH_CHUNKS_PER_GENERATOR,
    pedersen_hash_generators,
)
from masp_tpu_torch.host.primitives.pedersen import Personalization
from masp_tpu_torch.kernels import jubjub as KJ
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops import jubjub as J
from masp_tpu_torch.ops.field import FR

_log = logging.getLogger(__name__)


@lru_cache(maxsize=None)
def _chunk_points(n_chunks: int) -> np.ndarray:
    """(C, 9, 48) int32 rows: entry [c, d + 4] = d 2^(4 (c mod 63)) G_(c // 63)
    as its affine encoding (Z = 1). Built by doublings and additions, which
    give the same affine points as the JAX package's scalar multiplications,
    so the same limbs."""
    t0 = time.perf_counter()
    gens = pedersen_hash_generators()
    pts = []
    base = None
    for c in range(n_chunks):
        seg, j = divmod(c, PEDERSEN_HASH_CHUNKS_PER_GENERATOR)
        base = gens[seg] if j == 0 else base.double().double().double().double()
        m2 = base.double()
        mult = [base, m2, m2 + base, m2.double()]
        pts.extend([-p for p in reversed(mult)] + [ExtendedPoint.identity()] + mult)
    rows = np.concatenate(J.encode_points(pts), axis=1).astype(np.int32)
    _log.info("Pedersen chunk table of %d chunks built on the host in %.3f s", n_chunks,
              time.perf_counter() - t0)
    return rows.reshape(n_chunks, 9, KJ.PT)


def _chunk_tables(n_chunks: int, device="cuda") -> torch.Tensor:
    """The (C, 9, 48) chunk table on ``device``, made once per (C, device)."""
    dev = resolve_device(device)
    return device_const(("pedersen_chunks", n_chunks, dev),
                        lambda: torch.as_tensor(_chunk_points(n_chunks), device=dev))


def _digit_rows(personalization: Personalization, bits_rows: np.ndarray) -> np.ndarray:
    """(N, nbits) bool -> (N, C) int8 signed chunk digits (pedersen_hash.rs
    chunk encoding: d = (1 + a + 2b)(1 - 2c); zero-padded tail bits)."""
    n = bits_rows.shape[0]
    pers = np.asarray(personalization.get_bits(), dtype=bool)
    full = np.concatenate(
        [np.broadcast_to(pers, (n, pers.shape[0])), bits_rows], axis=1
    )
    pad = (-full.shape[1]) % 3
    if pad:
        full = np.concatenate([full, np.zeros((n, pad), dtype=bool)], axis=1)
    a = full[:, 0::3].astype(np.int8)
    b = full[:, 1::3].astype(np.int8)
    c = full[:, 2::3].astype(np.int8)
    return (1 + a + 2 * b) * (1 - 2 * c)


def batch_pedersen_hash_points(personalization: Personalization, bits_rows: np.ndarray,
                               device="cuda"):
    """N hashes of one bit length -> (X, Y, Z) coordinate tensors, (N, 16)
    each, on ``device``."""
    digits = _digit_rows(personalization, np.asarray(bits_rows, dtype=bool))
    _n, C = digits.shape
    table = _chunk_tables(C, device)
    idx = torch.as_tensor(np.ascontiguousarray(digits.T + 4).astype(np.int32), device=table.device)  # (C, N)
    rows = KJ.pedersen_fold(table, idx)
    return tuple(rows[:, i * FR.L : (i + 1) * FR.L] for i in range(3))


def batch_pedersen_hash(personalization: Personalization, bits_list,
                        device="cuda") -> list[ExtendedPoint]:
    """Batched <M_i> Pedersen hash; all inputs share one bit length (the
    protocol's uses, Merkle nodes and note commitments, are fixed-width).
    Exact host-typed results."""
    rows = np.asarray([[bool(b) for b in bits] for bits in bits_list], dtype=bool)
    if rows.size == 0 and len(bits_list) == 0:
        return []
    return J.decode_points(*batch_pedersen_hash_points(personalization, rows, device))


def _le_bit_rows(items: list[bytes], nbits: int) -> np.ndarray:
    arr = np.frombuffer(b"".join(items), dtype=np.uint8).reshape(len(items), 32)
    bits = np.unpackbits(arr, axis=1, bitorder="little")
    return bits[:, :nbits].astype(bool)


def batch_merkle_hash(depth: int, pairs: list[tuple[bytes, bytes]], device="cuda") -> list[bytes]:
    """The N parent nodes of one tree level in one fold (primitives/sapling.py
    merkle_hash semantics: Pedersen over both 255-bit children, parent = the
    affine u, 32 bytes little-endian); u = X / Z through one batched Fr
    inversion and the Fr product."""
    if not pairs:
        return []
    lhs = _le_bit_rows([l for l, _ in pairs], 255)
    rhs = _le_bit_rows([r for _, r in pairs], 255)
    rows = np.concatenate([lhs, rhs], axis=1)
    X, Y, Z = batch_pedersen_hash_points(Personalization.merkle_tree(depth), rows, device)
    u = F.mont_mul(FR, X, F.batch_mont_inv(FR, Z))
    return [v.to_bytes(32, "little") for v in F.decode(FR, u)]


__all__ = [
    "batch_pedersen_hash", "batch_pedersen_hash_points", "batch_merkle_hash",
]
