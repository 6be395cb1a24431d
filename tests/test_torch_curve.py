"""Parity of the port's G1/G2 point addition (the point-add kernel's plain
version and ops/weierstrass) with the JAX package's weierstrass_jax and the
host curve. Exact equality of limbs and of decoded points. The kernels
themselves are held against the plain version on the card by
tests/test_torch_card.py."""

import os
import random

import jax
import numpy as np
import pytest
import torch

from masp_tpu.curves.bls12_381 import G1 as HG1, G2 as HG2, R
from masp_tpu.ops import weierstrass_jax as WJ
from masp_tpu_torch.kernels import LAUNCHES
from masp_tpu_torch.kernels import point_add as PA
from masp_tpu_torch.ops import weierstrass as W
from masp_tpu_torch.ops.projective import pack_rows, unpack_rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under pytest-xdist, workers share the CPU: one intra-op thread each
    keeps torch's thread pools from oversubscribing it."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

GROUPS = {
    1: (HG1, WJ.G1Ops, WJ.encode_g1_points, W.G1Ops),
    2: (HG2, WJ.G2Ops, WJ.encode_g2_points, W.G2Ops),
}


def _pairs(grp, n_random: int, seed: int):
    """Random pairs plus identity+identity, P+P, P+(-P), identity+P, P+identity."""
    rng = random.Random(seed)
    g = grp.generator()
    p1 = [g * rng.randrange(1, R) for _ in range(n_random)]
    p2 = [g * rng.randrange(1, R) for _ in range(n_random)]
    p1 += [grp.identity(), p1[0], p1[1], grp.identity(), p1[2]]
    p2 += [grp.identity(), p1[0], -p1[1], p2[0], grp.identity()]
    return p1, p2


def _rows(coords) -> torch.Tensor:
    n = coords[0].shape[0]
    return torch.as_tensor(np.concatenate([np.asarray(c).reshape(n, -1) for c in coords], axis=1).astype(np.int32))


def _coords(group, rows):
    return tuple(np.asarray(c).astype(np.uint32) for c in unpack_rows(group, rows))


def _host_list(group, pts):
    """masp_tpu host points -> the port's host points (same coordinates)."""
    enc = WJ.encode_g1_points if group == 1 else WJ.encode_g2_points
    dec = W.decode_g1_points if group == 1 else W.decode_g2_points
    return dec(*enc(pts))


@pytest.mark.parametrize("group", [1, 2])
def test_point_add_matches_jax_and_host(group):
    hgrp, jops, enc, tops = GROUPS[group]
    p1, p2 = _pairs(hgrp, 11, 10 + group)
    P, Q = _rows(enc(p1)), _rows(enc(p2))
    want_pts = _host_list(group, [x + y for x, y in zip(p1, p2)])
    jadd = jax.jit(lambda p, q: WJ.point_add(jops, p, q))
    dec = W.decode_g1_points if group == 1 else W.decode_g2_points

    # affine-encoded operands (Z in {0, mont-1}): complete and leaf forms
    full = PA.point_add_plain(group, P, Q)
    leaf = PA.point_add_plain(group, P, Q, leaf01=True)
    want = _rows(jadd(_coords(group, P), _coords(group, Q)))
    assert torch.equal(full, want)
    assert torch.equal(leaf, want)  # the leaf form gives the complete limbs
    # JAX's leaf entry, compiled with XLA's backend optimisation off (the
    # same integer program, compiled in less time)
    args = (_coords(group, P), _coords(group, Q))
    jadd01 = jax.jit(lambda p, q: WJ.g_add01(jops, p, q)).lower(*args)
    jadd01 = jadd01.compile(compiler_options={"xla_backend_optimization_level": 0})
    assert torch.equal(leaf, _rows(jadd01(*args)))
    assert dec(*unpack_rows(group, full)) == want_pts

    # projective operands with general Z
    Pp = PA.point_add_plain(group, P, torch.roll(Q, 1, 0))
    Qp = PA.point_add_plain(group, torch.roll(P, 2, 0), Q)
    Qp[-5:] = Pp[-5:]  # P + P on projective lanes too
    got = PA.point_add_plain(group, Pp, Qp)
    assert torch.equal(got, _rows(jadd(_coords(group, Pp), _coords(group, Qp))))
    sums = [a + b for a, b in zip(dec(*unpack_rows(group, Pp)), dec(*unpack_rows(group, Qp)))]
    assert dec(*unpack_rows(group, got)) == sums

    # the dispatching group ops agree with the kernel's plain version
    pc, qc = unpack_rows(group, P), unpack_rows(group, Q)
    assert torch.equal(pack_rows(W.g_add(tops, pc, qc)), full)
    assert torch.equal(pack_rows(W.g_add01(tops, pc, qc)), full)
    assert torch.equal(pack_rows(W.point_add(tops, pc, qc)), full)


@pytest.mark.parametrize("group", [1, 2])
def test_codecs_and_to_affine_match_jax_and_host(group):
    hgrp, jops, enc, tops = GROUPS[group]
    pts = _pairs(hgrp, 4, 20 + group)[0]
    tenc = W.encode_g1_points if group == 1 else W.encode_g2_points
    ported = _host_list(group, pts)
    for a, b in zip(tenc(ported), enc(pts)):
        assert np.array_equal(a, b)
    X, Y, Z = (torch.as_tensor(np.asarray(c).astype(np.int32)) for c in enc(pts))
    x, y = W.to_affine(tops, (X, Y, Z))
    dec_aff = W.decode_affine_g1 if group == 1 else W.decode_affine_g2
    assert dec_aff(x, y) == ported
    ident = W.identity_like(tops, X[:1])
    assert torch.equal(pack_rows(ident), _rows(enc([hgrp.identity()])))


def test_point_select():
    a = tuple(torch.full((3, 24), i, dtype=torch.int32) for i in range(3))
    b = tuple(torch.full((3, 24), 9, dtype=torch.int32) for _ in range(3))
    out = W.point_select(torch.tensor([1, 0, 1]), a, b)
    assert out[1][:, 0].tolist() == [1, 9, 1]


def test_point_add_wrapper_checks_inputs():
    rows = torch.zeros(4, 72, dtype=torch.int32)
    with pytest.raises(ValueError):
        PA.point_add(3, rows, rows)
    with pytest.raises(ValueError):
        PA.point_add(2, rows, rows)
    with pytest.raises(ValueError):
        PA.point_add(1, rows, rows[:3])
    before = dict(LAUNCHES)
    PA.point_add(1, rows, rows)
    assert LAUNCHES == before
