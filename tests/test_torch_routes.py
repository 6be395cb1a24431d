"""The prover's off-by-default MSM routes in the port against the JAX
package: the BGMW table and its MSM, the batched sorted MSM, host digits,
and proofs through each route (host digits, the stacked G1 MSMs, the fused
prove, BGMW for h, the lane-private Pippenger) byte for byte against
masp_tpu.groth16.reference.host_proof and the port's default proof; marked
slow, the same proofs against masp_tpu's create_proof_from_assembly with the
same module constants on both sides, and the BGMW table's rows against the
JAX function's. Tolerance everywhere: exact limbs and bytes."""

import os

import numpy as np
import pytest
import torch

from masp_tpu.groth16 import prover as P
from masp_tpu.groth16 import reference as REF
from masp_tpu.ops import msm_sorted as JMS
from masp_tpu.ops import weierstrass_jax as WJ
from masp_tpu_torch import groth16 as TG
from masp_tpu_torch.groth16 import prover as TP
from masp_tpu_torch.host.bls12_381 import G1, R
from masp_tpu_torch.ops import msm_sorted as MS
from masp_tpu_torch.ops import weierstrass as W
from masp_tpu_torch.ops.field import FQ
from masp_tpu_torch.ops.projective import unpack_rows
from tests.test_torch_prover import BitsCircuit, _host_params, _port_params, _witness

# (r, s) and the witness of every route's proof
RS = (3, 9)
BITS = [1, 0, 1, 1, 0, 1]
# the proofs' module constants: c = 4 halves the CPU's sequential bucket
# reduction, the split forced on for BitsCircuit's 8 bit wires, BGMW at
# c = 5 (51 windows, groups [32, 16, 2, 1])
BASE = {"MASP_MSM_C": "4", "MASP_MSM_SPLIT_MIN": "2", "MASP_MSM_BGMW_C": "5"}
ROUTES = {
    "host_digits": {"MASP_MSM_FROM_LIMBS": "0"},
    "stacked": {"MASP_MSM_STACK": "1"},
    "fused": {"MASP_MSM_FUSED": "1"},
    "bgmw_h": {"MASP_MSM_BGMW_H": "1"},
    "lanes": {"MASP_MSM": "lanes"},
}
# the lanes route on the CPU at 8 / 4 lanes (the reference's 64 / 32 make
# BitsCircuit's one step a 64-lane combine of plain adds); the slow test
# against masp_tpu runs both packages at 64 / 32
CPU_LANES = (8, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under pytest-xdist, workers share the CPU: one intra-op thread each."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _scan_ladder(monkeypatch):
    monkeypatch.setattr(MS, "AFFINE_LADDER", False)


def _route(monkeypatch, env: dict, lanes=CPU_LANES, jax_side: bool = False) -> dict:
    """Set the port's module constants as msm_flags derives them from
    ``env`` (and masp_tpu's to the same values with ``jax_side``)."""
    flags = TP.msm_flags(env)
    flags["MSM_LANES_G1"], flags["MSM_LANES_G2"] = lanes
    for name, value in flags.items():
        monkeypatch.setattr(TP, name, value)
        if jax_side:
            monkeypatch.setattr(P, name, value)
    return flags


@pytest.fixture(scope="module")
def bits_case():
    """BitsCircuit's parameters (both packages), witness, host_proof bytes
    and the port's default-route proof bytes (c = 4, split forced)."""
    params, _ = _host_params(BitsCircuit())
    tparams = _port_params(params)
    cs, asm = _witness(BitsCircuit(BITS))
    want = REF.host_proof(cs, params, *RS).write()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MS, "AFFINE_LADDER", False)
        _route(mp, BASE)
        default = TG.create_proof_from_assembly(asm, tparams, *RS, device="cpu").write()
    return params, tparams, cs, asm, want, default


def _host_msm(points, scalars):
    acc = G1.identity()
    for p, s in zip(points, scalars):
        acc = acc + p * s
    return acc


def _limb_rows(scalars) -> np.ndarray:
    return np.array([[(s >> (16 * j)) & 0xFFFF for j in range(16)] for s in scalars], dtype=np.int32)


def _packed(points) -> np.ndarray:
    coords = W.encode_g1_points(points)
    return np.concatenate([np.asarray(c).reshape(len(points), -1) for c in coords], axis=1).astype(np.int32)


def _point(row):
    return W.decode_g1_points(*unpack_rows(1, row.reshape(1, -1)))[0]


def _bgmw_inputs():
    """tests/test_msm_sorted.py's BGMW inputs: 16 points, the last the
    identity, and their scalars, the third zero."""
    rng = np.random.default_rng(13)
    n = 16
    g = G1.generator()
    points = [g * (int(rng.integers(1, 1 << 62))) for _ in range(n - 1)]
    points.append(G1.identity())
    scalars = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(n)]
    scalars[2] = 0
    return points, scalars


def test_bgmw_msm_matches_host():
    """build_bgmw_table + bgmw_msm_from_limbs at c = 5 (51 windows, groups
    [32, 16, 2, 1]) on the JAX test's inputs against host ints; the table's
    shape, slab 0 the query itself, every slab row affine or the identity
    (Z in {0, mont-1}) and equal to [2^(5 w)] P_i."""
    points, scalars = _bgmw_inputs()
    assert MS._pow2_groups(51) == [32, 16, 2, 1] and MS._pow2_groups(22) == [16, 4, 2]
    rows = torch.as_tensor(_packed(points))
    table = MS.build_bgmw_table(W.G1Ops, rows, 5)
    n = len(points)
    assert table.shape == (MS.n_windows_for(5) * n, 72)
    assert torch.equal(table[:n], rows)
    one = torch.as_tensor(np.asarray(FQ.ONE_MONT, dtype=np.int32))
    z = table[:, 48:]
    assert bool(((z == 0).all(dim=1) | (z == one).all(dim=1)).all())
    for w in (1, 2, 50):
        slab = W.decode_g1_points(*unpack_rows(1, table[w * n : (w + 1) * n]))
        assert slab == [p * (1 << (5 * w)) for p in points], w
    got = MS.bgmw_msm_from_limbs(W.G1Ops, table, torch.as_tensor(_limb_rows(scalars)), 5)
    assert _point(got) == _host_msm(points, scalars)
    with pytest.raises(ValueError, match="G1"):
        MS.build_bgmw_table(W.G2Ops, torch.zeros(2, 144, dtype=torch.int32), 5)


def test_sorted_msm_batch_matches_single_msms(monkeypatch):
    """sorted_msm_batch at Q = 4, N = 64, c = 4 against four sorted_msm
    calls (the same limbs: each query's arithmetic is what it is alone) and
    host ints, with identities and zero scalars among the inputs; the batch
    makes as many point-add calls (kernel launches on a card) as one
    sorted_msm: each ladder level and reduction step is one call over all
    Q queries."""
    rng = np.random.default_rng(21)
    Q, N, c = 4, 64, 4
    g = G1.generator()
    pts = [[g * int(rng.integers(1, 1 << 62)) for _ in range(N)] for _ in range(Q)]
    scs = [[int.from_bytes(rng.bytes(32), "little") % R for _ in range(N)] for _ in range(Q)]
    pts[1][5] = G1.identity()
    scs[2][7] = 0
    rows = torch.as_tensor(np.stack([_packed(p) for p in pts]))
    digits = torch.stack([MS.windows_from_limbs(torch.as_tensor(_limb_rows(s)), c) for s in scs])
    calls = []
    add_rows = MS._add_rows
    monkeypatch.setattr(MS, "_add_rows", lambda *a: calls.append(a[1].shape[0]) or add_rows(*a))
    got = MS.sorted_msm_batch(W.G1Ops, rows, digits, c)
    n_batch = len(calls)
    assert got.shape == (Q, 72)
    for q in range(Q):
        calls.clear()
        assert torch.equal(got[q], MS.sorted_msm(W.G1Ops, rows[q], digits[q], c)), q
        assert len(calls) == n_batch, q
        assert _point(got[q]) == _host_msm(pts[q], scs[q]), q


def test_digits_from_u64_matches_reference(monkeypatch):
    """The host digits at c = 4 and 8 against masp_tpu's _digits_from_u64,
    padded rows and edge scalars (0, 1, r - 1) included."""
    rng = np.random.default_rng(4)
    vals = [0, 1, R - 1] + [int.from_bytes(rng.bytes(32), "little") % R for _ in range(29)]
    arr = np.frombuffer(b"".join(v.to_bytes(32, "little") for v in vals), dtype=np.uint64).reshape(-1, 4)
    for c in (4, 8):
        monkeypatch.setattr(TP, "MSM_C", c)
        monkeypatch.setattr(P, "MSM_C", c)
        got = TP._digits_from_u64(arr, 40)
        assert got.dtype == np.int32 and got.shape == (40, 256 // c)
        assert np.array_equal(got, P._digits_from_u64(arr, 40)), c
        assert [sum(int(d) << (c * w) for w, d in enumerate(row)) for row in got[:32]] == vals
    monkeypatch.setattr(TP, "MSM_C", 5)
    with pytest.raises(ValueError, match="c = 4 or 8"):
        TP._digits_from_u64(arr, 40)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_proof_matches_host_reference(route, bits_case, monkeypatch):
    """BitsCircuit proved through each route on the CPU, byte-equal to
    host_proof and to the port's default proof; the device cache holds the
    route's layout (rebuilt from the default's) and no other route's rows."""
    params, tparams, cs, asm, want, default = bits_case
    flags = _route(monkeypatch, {**BASE, **ROUTES[route]})
    proof = TG.create_proof_from_assembly(asm, tparams, *RS, device="cpu")
    assert proof.write() == want == default
    cache = tparams.device
    layout = {"stacked": "stacked", "lanes": "lanes"}.get(route, "sorted")
    assert cache["layout"] == layout
    assert ("g1_stack" in cache) == (layout == "stacked")
    # a table built by the BGMW route stays in the sorted layout's cache
    # (the fused route, as the reference's, does not read it)
    assert "h_bgmw" in cache if route == "bgmw_h" else layout == "sorted" or "h_bgmw" not in cache
    assert any(k.endswith("_small") for k in cache) == flags["MSM_SPLIT"] == (layout == "sorted")
    if layout == "lanes":
        assert cache["n_g1"] % CPU_LANES[0] == 0 and cache["b_g2"][0].shape[0] % CPU_LANES[1] == 0
    if layout == "stacked":
        assert cache["g1_stack"].shape == (4, cache["n_g1"], 72)
        with pytest.raises(ValueError, match="stacked"):
            TP.create_proofs_from_assemblies([asm], tparams, [RS], device="cpu")


@pytest.mark.parametrize("route", ["fused", "bgmw_h"])
def test_batch_routes_match_host_reference(route, bits_case, monkeypatch):
    """create_proofs_from_assemblies of two witnesses through the fused and
    the BGMW route, each proof byte-equal to host_proof."""
    params, tparams, _, _, _, _ = bits_case
    _route(monkeypatch, {**BASE, **ROUTES[route]})
    witnesses = [_witness(BitsCircuit(b)) for b in ([0, 1, 1, 0, 1, 1], [1, 1, 0, 1, 0, 0])]
    rs = [(5, 7), (11, 2)]
    proofs = TP.create_proofs_from_assemblies([a for _, a in witnesses], tparams, rs, device="cpu")
    for (cs, _), (r, s), proof in zip(witnesses, rs, proofs):
        assert proof.write() == REF.host_proof(cs, params, r, s).write()


@pytest.mark.slow
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_proof_matches_jax_prover(route, monkeypatch):
    """Each route against masp_tpu's create_proof_from_assembly, with the
    same module constants on both sides (lanes at the reference's 64 / 32);
    minutes of XLA compilation each."""
    env = {**BASE, **ROUTES[route]}
    _route(monkeypatch, env, lanes=(64, 32), jax_side=True)
    params, _ = _host_params(BitsCircuit())
    tparams = _port_params(params)
    cs, asm = _witness(BitsCircuit(BITS))
    want = P.create_proof_from_assembly(cs, params, *RS)
    got = TG.create_proof_from_assembly(asm, tparams, *RS, device="cpu")
    assert got.write() == want.write()


@pytest.mark.slow
def test_bgmw_table_matches_jax():
    """build_bgmw_table's rows against masp_tpu's (its XLA compile takes
    minutes), limb for limb."""
    points, _ = _bgmw_inputs()
    rows = _packed(points)
    want = np.asarray(JMS.build_bgmw_table(WJ.G1Ops, rows.astype(np.uint32), 5))
    got = MS.build_bgmw_table(W.G1Ops, torch.as_tensor(rows), 5)
    assert np.array_equal(got.numpy(), want.astype(np.int32))
