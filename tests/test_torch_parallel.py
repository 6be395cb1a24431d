"""The port's multi-device layer (masp_tpu_torch/parallel), its lane-private
Pippenger (ops/msm.pippenger_msm) and its signed digits (ops/msm_sorted),
against the JAX package (masp_tpu/parallel, ops/msm.py, ops/msm_sorted.py)
on its virtual 8-device CPU mesh (tests/conftest.py), the host ints and the
host provers (masp_tpu/groth16/reference.py, masp_tpu_torch/groth16/
reference.py). Exact equality throughout; a sharded MSM adds in another
order than a single-device one, so those two are compared as affine points.

The port's meshes here are virtual CPU meshes (``devices=["cpu"] * D``):
every shard's ``.device`` is asserted against its position's. The sharded
sorted MSMs and the Pippengers of the JAX package compile for minutes on
the CPU, so their limb comparisons are marked slow; the default run holds
the same functions to the port's single-device results and host ints. One
item runs the two-process demo over gloo.
"""

import os
import random
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masp_tpu.curves.bls12_381 import G1 as HG1, G2 as HG2, R
from masp_tpu.groth16 import generator as JGEN
from masp_tpu.groth16 import prover as JP
from masp_tpu.groth16 import reference as JREF
from masp_tpu.groth16.domain import Domain as JDomain
from masp_tpu.groth16.structures import Parameters as JParameters, VerifyingKey as JVerifyingKey
from masp_tpu.ops import msm as MJ
from masp_tpu.ops import msm_sorted as MSJ
from masp_tpu.ops import weierstrass_jax as WJ
from masp_tpu.parallel import distributed as DJ
from masp_tpu.parallel import mesh as PMJ
from masp_tpu.r1cs.cs import ONE, ProvingAssembly, lc_var
from masp_tpu_torch import groth16 as TG
from masp_tpu_torch.groth16 import prover as TP
from masp_tpu_torch.groth16 import reference as TREF
from masp_tpu_torch.groth16.domain import Domain
from masp_tpu_torch.kernels import point_add as PA
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops import msm as M
from masp_tpu_torch.ops import msm_sorted as MS
from masp_tpu_torch.ops import weierstrass as W
from masp_tpu_torch.ops.field import FR
from masp_tpu_torch.ops.projective import unpack_rows
from masp_tpu_torch.parallel import distributed as D
from masp_tpu_torch.parallel import mesh as PM

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under pytest-xdist, workers share the CPU: one intra-op thread each
    keeps torch's thread pools from oversubscribing it."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n, axis="msm"):
    return PM.make_mesh(n, axis=axis, devices=["cpu"] * n)


def _placed(sh, rows=None):
    """Every shard on its position's device (and of ``rows`` rows)."""
    for p in sh.mesh.local_positions():
        assert sh.shards[p].device == sh.mesh.device(p)
        assert rows is None or sh.shards[p].shape[0] == rows
    return sh


def _t(arr):
    return torch.as_tensor(np.asarray(arr).astype(np.int32))


def _fr_vals(n, seed):
    rng = random.Random(seed)
    return [0, 1, R - 1] + [rng.randrange(R) for _ in range(n - 3)]


def _packed(group, pts):
    enc = WJ.encode_g1_points if group == 1 else WJ.encode_g2_points
    return np.concatenate([np.asarray(c).reshape(len(pts), -1) for c in enc(pts)], axis=1)


def _decode(group, row):
    dec = W.decode_g1_points if group == 1 else W.decode_g2_points
    return dec(*unpack_rows(group, torch.as_tensor(row).reshape(1, -1)))[0]


def _port(group, pt):
    """A host point of the JAX package as the port's host point."""
    enc = WJ.encode_g1_points if group == 1 else WJ.encode_g2_points
    dec = W.decode_g1_points if group == 1 else W.decode_g2_points
    return dec(*enc([pt]))[0]


def _host_msm(grp, pts, scalars):
    acc = grp.identity()
    for p, s in zip(pts, scalars):
        acc = acc + p * s
    return acc


def _mesh_msm_case():
    """tests/test_parallel_mesh.py:46's shapes: 64 G1 points, 64 scalars."""
    nprng = np.random.default_rng(31)
    n = 64
    g = HG1.generator()
    points = [g * int(k) for k in nprng.integers(1, 1 << 40, n)]
    scalars = [int.from_bytes(nprng.bytes(32), "little") % R for _ in range(n)]
    return points, scalars


# --- the sharded NTT and h pipeline ------------------------------------------------

def test_sharded_ntt_matches_reference_and_domain():
    """D = 1, 2, 4, 8 at m = 64: forward from a whole tensor, inverse from
    the Sharded result (the all-gather route), each equal to Domain.fft /
    ifft and to the JAX package's sharded_ntt on its 8-device mesh, limb
    for limb; the round trip gives the values back."""
    m = 64
    dom, jdom = Domain(m, device="cpu"), JDomain(m)
    vals = _fr_vals(m, 21)
    x = F.encode(FR, vals)
    want = dom.fft(_t(x))
    for n in (1, 2, 4, 8):
        mesh, jmesh = _cpu_mesh(n, "ntt"), PMJ.make_mesh(n, axis="ntt")
        fwd = _placed(PM.sharded_ntt(mesh, dom, _t(x), axis="ntt"), m // n)
        assert fwd.axis == "ntt" and fwd.shape == (m, FR.L)
        jf = jax.jit(lambda v: PMJ.sharded_ntt(jmesh, jdom, v, axis="ntt"))(jnp.asarray(x))
        assert torch.equal(PM.gather(fwd), want), n
        assert np.array_equal(PM.gather(fwd).numpy(), np.asarray(jf).astype(np.int32)), n
        back = _placed(PM.sharded_ntt(mesh, dom, fwd, axis="ntt", inverse=True), m // n)
        jb = jax.jit(lambda v: PMJ.sharded_ntt(jmesh, jdom, v, axis="ntt", inverse=True))(jf)
        assert np.array_equal(PM.gather(back).numpy(), np.asarray(jb).astype(np.int32)), n
        assert torch.equal(PM.gather(back), dom.ifft(want)) and F.decode(FR, PM.gather(back)) == vals
    with pytest.raises(ValueError, match="power of two"):
        PM.sharded_ntt(_cpu_mesh(3, "ntt"), dom, _t(x), axis="ntt")


def test_sharded_h_pipeline_matches_reference_and_host():
    """sharded_h_pipeline at m = 64 on 4 positions: limb for limb the JAX
    package's sharded_h_pipeline and the port's single-device h_pipeline,
    and the host bigint pipelines of both packages."""
    m = 64
    rng = random.Random(41)
    vals = [[rng.randrange(R) for _ in range(m)] for _ in range(3)]
    abc = [F.encode(FR, v, mont=False) for v in vals]
    mesh = _cpu_mesh(4)
    got = _placed(PM.sharded_h_pipeline(mesh, Domain(m, device="cpu"), *(_t(v) for v in abc), axis="msm"), m // 4)
    h = PM.gather(got)
    jh = jax.jit(lambda a, b, c: PMJ.sharded_h_pipeline(PMJ.make_mesh(4, axis="msm"), JDomain(m), a, b, c,
                                                        axis="msm"))(*(jnp.asarray(v) for v in abc))
    assert np.array_equal(h.numpy(), np.asarray(jh).astype(np.int32))
    assert torch.equal(h, TP.h_pipeline(Domain(m, device="cpu"), torch.stack([_t(v) for v in abc])))
    assert F.decode(FR, h) == JREF.host_h_from_vals(*vals, m) == TREF.host_h_from_vals(*vals, m)


# --- the sharded sorted MSM --------------------------------------------------------

def _ssm_case(case):
    """(group, points, scalars, packed rows, digits or limbs, c, positions,
    keywords) of each sharded MSM case."""
    points, scalars = _mesh_msm_case()
    if case == "g1-c8":
        return 1, points, scalars, _t(_packed(1, points)), torch.as_tensor(MJ.scalars_to_digits(scalars, 8, 256)), 8, 4, {}
    if case == "signed-c4":
        limbs = _t(F.encode(FR, scalars, mont=False))
        return 1, points, scalars, _t(_packed(1, points)), limbs, 4, 4, {"from_limbs": True, "signed": True}
    nprng = np.random.default_rng(33)
    pts2 = [HG2.generator() * int(k) for k in nprng.integers(1, 1 << 40, 16)]
    pts2[3] = HG2.identity()
    sc2 = scalars[:16]
    return 2, pts2, sc2, _t(_packed(2, pts2)), torch.as_tensor(MJ.scalars_to_digits(sc2, 4, 256)), 4, 2, {}


@pytest.mark.parametrize("case", ["g1-c8", "g2-c4", "signed-c4"])
def test_sharded_sorted_msm_matches_single_device_and_host(case):
    """G1 at c = 8 on 4 positions (tests/test_parallel_mesh.py:46's
    shapes), G2 at c = 4 on 2, and signed c = 4 digits extracted on each of
    4 shards: every position ends with the same limbs (the butterfly's
    partners add the same two states, and the complete add is symmetric in
    its operands, checked here on the edge cases too), equal as a point to
    the host MSM, and at c = 4 to the port's single-device sorted MSM."""
    group, pts, sc, pk, dg, c, n, kw = _ssm_case(case)
    fops = W.G1Ops if group == 1 else W.G2Ops
    grp = HG1 if group == 1 else HG2
    mesh = _cpu_mesh(n)
    out = _placed(PM.sharded_sorted_msm(mesh, fops, pk, dg, c, axis="msm", **kw))
    assert out.axis is None
    rows = [out.shards[p] for p in mesh.local_positions()]
    assert all(torch.equal(r, rows[0]) for r in rows)
    assert _decode(group, rows[0]) == _port(group, _host_msm(grp, pts, sc))
    if c == 4:
        single = (MS.sorted_msm_from_limbs(fops, pk, dg, c, signed=True) if kw else MS.sorted_msm(fops, pk, dg, c))
        assert _decode(group, rows[0]) == _decode(group, single)
    g = grp.generator()
    a = [g, g, g, grp.identity(), grp.identity(), g * 5]
    b = [g * 3, g, -g, g, grp.identity(), g * 7]
    pa, pb = _t(_packed(group, a)), _t(_packed(group, b))
    assert torch.equal(PA.point_add(group, pa, pb), PA.point_add(group, pb, pa))


# --- the lane-private Pippenger, dp_batch_ntt, digits --------------------------------

def test_pippenger_sharded_pippenger_and_dp_batch_ntt():
    """pippenger_msm (c = 4, 4 lanes) and sharded_pippenger on 4 positions
    equal the host MSM and each other as points; pad_points_for_msm and
    fr_digits_device equal the JAX package's; dp_batch_ntt on a dp = 2 x
    msm = 2 mesh equals the JAX package's limb for limb and Domain.fft."""
    rng = random.Random(51)
    pts = [HG1.generator() * rng.randrange(1, 1 << 30) for _ in range(61)]
    pts[5] = HG1.identity()
    sc = [rng.randrange(1 << 30) for _ in range(61)]
    coords, digits = M.pad_points_for_msm(W.G1Ops, WJ.encode_g1_points, pts, sc, lanes=4, c=4, num_bits=32)
    jcoords, jdigits = MJ.pad_points_for_msm(WJ.G1Ops, WJ.encode_g1_points, pts, sc, lanes=4, c=4, num_bits=32)
    assert all(np.array_equal(a, b) for a, b in zip(coords, jcoords)) and np.array_equal(digits, jdigits)
    xyz = tuple(_t(x) for x in coords)
    single = M.pippenger_msm(W.G1Ops, xyz, torch.as_tensor(digits), 4, lanes=4)
    want = _port(1, _host_msm(HG1, pts, sc))
    assert W.decode_g1_points(*(x[None] for x in single))[0] == want
    mesh = _cpu_mesh(4)
    sharded = _placed(PM.sharded_pippenger(mesh, W.G1Ops, xyz, torch.as_tensor(digits), 4, 4, axis="msm"))
    assert _decode(1, PM.gather(sharded)) == want
    with pytest.raises(ValueError, match="lanes"):
        M.pippenger_msm(W.G1Ops, tuple(x[:63] for x in xyz), torch.as_tensor(digits[:63]), 4, lanes=4)

    m = 64
    h = F.encode(FR, _fr_vals(m, 52))
    got = M.fr_digits_device(_t(h))
    assert np.array_equal(got.numpy(), np.asarray(MJ.fr_digits_device(jnp.asarray(h))))

    vals = np.stack([F.encode(FR, _fr_vals(m, 60 + b)) for b in range(4)])
    mesh2 = PM.Mesh(np.asarray([torch.device("cpu")] * 4, dtype=object).reshape(2, 2), ("dp", "msm"))
    out = _placed(PM.dp_batch_ntt(mesh2, Domain(m, device="cpu"), _t(vals), axis="dp"), 2)
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dp", "msm"))
    jout = jax.jit(lambda v: PMJ.dp_batch_ntt(jmesh, JDomain(m), v, axis="dp"))(jnp.asarray(vals))
    assert np.array_equal(PM.gather(out).numpy(), np.asarray(jout).astype(np.int32))
    assert torch.equal(PM.gather(out), Domain(m, device="cpu").fft(_t(vals)))
    assert PM.dp_sharding(mesh2).put(_t(vals)).shards[3].shape == (2, m, FR.L)


def _signed_cases(c):
    """0, 1, r - 1, every window 2^(c-1) (below bit 250), then seeded values."""
    half = 1 << (c - 1)
    every = sum(half << (c * w) for w in range(250 // c))
    rng = random.Random(70 + c)
    return [0, 1, R - 1, every] + [rng.randrange(R) for _ in range(28)]


def test_signed_windows_match_reference():
    """windows_from_limbs(signed=True) equals the JAX package's digits at
    c = 4, 8, 10 and 16 (edge patterns first), every digit in
    [-2^(c-1), 2^(c-1)] and the digits summing back to the scalar; the
    window counts equal the reference's for every c, signed or not."""
    for c in range(2, 17):
        for signed in (False, True):
            assert MS.n_windows_for(c, signed) == MSJ.n_windows_for(c, signed), (c, signed)
    assert MS.n_buckets(8, True) == 129 and MS.n_buckets(8) == 256
    for c in (4, 8, 10, 16):
        vals = _signed_cases(c)
        limbs = F.encode(FR, vals, mont=False)
        got = MS.windows_from_limbs(_t(limbs), c, signed=True).numpy()
        want = np.asarray(jax.jit(lambda x: MSJ.windows_from_limbs(x, c, signed=True))(jnp.asarray(limbs)))
        assert np.array_equal(got, want), c
        assert got.min() >= -(1 << (c - 1)) and got.max() <= 1 << (c - 1)
        for row, v in zip(got, vals):
            assert sum(int(d) << (c * w) for w, d in enumerate(row)) == v
        unsigned = MS.windows_from_limbs(_t(limbs), c).numpy()
        assert np.array_equal(unsigned, np.asarray(MSJ.windows_from_limbs(jnp.asarray(limbs), c)))


@pytest.mark.parametrize("group", [1, 2])
def test_signed_sorted_msm_matches_host(monkeypatch, group):
    """The signed sorted MSM on the scan ladder and on the batch-affine
    ladder (one affine level), G1 and G2, c = 4 and 8, equals the host
    MSM; its buckets hold the signed digit classes' sums."""
    grp = HG1 if group == 1 else HG2
    fops = W.G1Ops if group == 1 else W.G2Ops
    n = 16 if group == 1 else 8
    rng = random.Random(80 + group)
    pts = [grp.generator() * rng.randrange(1, R) for _ in range(n)]
    pts[1] = grp.identity()
    sc = _signed_cases(8)[:n]
    pk, limbs = _t(_packed(group, pts)), _t(F.encode(FR, sc, mont=False))
    want = _port(group, _host_msm(grp, pts, sc))
    monkeypatch.setattr(MS, "AFFINE_LEVELS", 1)
    for affine in (False, True):
        monkeypatch.setattr(MS, "AFFINE_LADDER", affine)
        for c in (4, 8):
            got = MS.sorted_msm_from_limbs(fops, pk, limbs, c)  # signed by default, as the reference's
            assert _decode(group, got) == want, (affine, c)
    digits = MS.windows_from_limbs(limbs, 4, signed=True)
    buckets = MS.window_buckets(fops, pk, digits, 4, signed=True)
    assert buckets.shape[:2] == (digits.shape[1], 9)
    d = digits.numpy()
    for w in (0, 1, 63):
        for k in range(9):
            acc = grp.identity()
            for i in np.nonzero(np.abs(d[:, w]) == k)[0]:
                acc = acc + (-pts[i] if d[i, w] < 0 else pts[i])
            assert _decode(group, buckets[w, k]) == _port(group, acc), (w, k)


# --- the mesh prover -----------------------------------------------------------------

class Chain:
    """tests/test_parallel_mesh.py:118's squaring chain (m = 64 at 60)."""

    def __init__(self, x, k):
        self.x, self.k = x, k

    def synthesize(self, cs):
        v = cs.alloc("x0", self.x)
        cur = self.x
        for i in range(self.k):
            nxt = cur * cur % R
            nv = cs.alloc(f"x{i + 1}", nxt)
            cs.enforce(f"sq{i}", lc_var(v), lc_var(v), lc_var(nv))
            v, cur = nv, nxt
        out = cs.alloc_input("out", cur)
        cs.enforce("out", lc_var(v), lc_var(ONE), lc_var(out))


_CHAINS = {}


def _chain_case(k):
    """A k-squaring chain's witness in both packages, and
    random-but-consistent parameters (the reference test's draw) in both;
    built once per k."""
    if k in _CHAINS:
        return _CHAINS[k]
    cs = ProvingAssembly()
    Chain(12345, k).synthesize(cs)
    JGEN._add_input_constraints(cs)
    m = 1 << (cs.num_constraints - 1).bit_length()
    a_density, b_density = JGEN._densities(cs)
    nprng = np.random.default_rng(7)

    def g1():
        return HG1.generator() * int(nprng.integers(1, 1 << 40))

    def g2():
        return HG2.generator() * int(nprng.integers(1, 1 << 40))

    vk = JVerifyingKey(alpha_g1=g1(), beta_g1=g1(), beta_g2=g2(), gamma_g2=g2(), delta_g1=g1(), delta_g2=g2(),
                       ic=[g1() for _ in range(cs.num_inputs)])
    params = JParameters(vk=vk, h=[g1() for _ in range(m - 1)], l=[g1() for _ in range(cs.num_aux)],
                         a=[g1() for _ in range(int(a_density.sum()))],
                         b_g1=[g1() for _ in range(int(b_density.sum()))],
                         b_g2=[g2() for _ in range(int(b_density.sum()))])
    enc1, enc2 = WJ.encode_g1_points, WJ.encode_g2_points
    tparams = TG.params_from_arrays(
        enc1([vk.alpha_g1, vk.beta_g1, vk.delta_g1]), enc2([vk.beta_g2, vk.gamma_g2, vk.delta_g2]),
        enc1(vk.ic), enc1(params.h), enc1(params.l), enc1(params.a), enc1(params.b_g1), enc2(params.b_g2))
    indptr, var_idx, coeffs = JP._csr_for(cs)
    asm = TG.assembly_from_arrays(cs.num_inputs, indptr, var_idx, coeffs, JP._assignment_u64(cs))
    _CHAINS[k] = cs, params, asm, tparams, m
    return _CHAINS[k]


def test_mesh_prover_matches_single_and_host_proof(monkeypatch):
    """create_proof_from_assembly(mesh=) of tests/test_parallel_mesh.py:118's
    chain (m = 64, c = 4) on 2 positions equals the port's single-device
    proof, the JAX package's host_proof and the port's host_proof byte for
    byte; the queries sit sharded over "msm", unsplit, keyed by the mesh."""
    cs, params, asm, tparams, m = _chain_case(60)
    monkeypatch.setattr(TP, "MSM_C", 4)
    want = JREF.host_proof(cs, params, 11, 22).write()
    assert TG.create_proof_from_assembly(asm, tparams, 11, 22, device="cpu").write() == want
    mesh = _cpu_mesh(2)
    sharded = TG.create_proof_from_assembly(asm, tparams, 11, 22, device="cpu", mesh=mesh)
    assert sharded.write() == want == TREF.host_proof(asm, tparams, 11, 22).write()
    assert tparams.device["mesh"] == mesh.key and not any(k.endswith("_small") for k in tparams.device)
    for q in ("h", "l", "a", "b_g1", "b_g2"):
        _placed(tparams.device[q], tparams.device[q].shape[0] // 2)
    assert tparams.device["h"].shape[0] == m


def test_mesh_batch_signed_and_host_abc_match_host_proof(monkeypatch):
    """On a 12-squaring chain (m = 16, c = 4): create_proofs_from_assemblies
    (mesh=) of two proofs on 2 positions equals host_proof for each (r, s);
    the single-device proof with signed digits (MASP_MSM_SIGNED) and with
    the a/b/c values from the host (MASP_ABC_DEVICE=0) equals it too; the h
    scalars' gather and re-split (h rows padded past m) equal the
    single-device scalars."""
    cs, params, asm, tparams, m = _chain_case(12)
    monkeypatch.setattr(TP, "MSM_C", 4)
    mesh = _cpu_mesh(2)
    rs = [(11, 22), (33, 44)]
    batch = TP.create_proofs_from_assemblies([asm, asm], tparams, rs, device="cpu", mesh=mesh)
    want = [JREF.host_proof(cs, params, r, s).write() for r, s in rs]
    assert [p.write() for p in batch] == want
    monkeypatch.setattr(TP, "MSM_SIGNED", True)
    monkeypatch.setattr(TP, "ABC_DEVICE", False)
    assert TG.create_proof_from_assembly(asm, tparams, 11, 22, device="cpu").write() == want[0]
    assert tparams.device["mesh"] is None
    h = _t(F.encode(FR, _fr_vals(16, 90)))
    hs = PM.shard(mesh, h, "msm")
    for n_h in (16, 32):
        got = _placed(TP._h_scalars_sharded(mesh, hs, 16, n_h), n_h // 2)
        assert torch.equal(PM.gather(got), TP._h_scalar_input(h, 16, n_h)), n_h


# --- the multi-process runtime ---------------------------------------------------

def test_distributed_single_process(monkeypatch):
    """parallel/distributed.py in one process, as tests/test_distributed.py
    checks the reference: initialize is a no-op and idempotent; pod_mesh's
    axes, its -1 rule and its errors; local_job_slice equal to the
    reference's for every (n_jobs, process_count, process_id) up to 9;
    global_from_local splits rows onto the positions. make_mesh without
    enough CUDA devices raises, and the backend defaults to NCCL."""
    import inspect

    for var in ("MASP_COORDINATOR", "MASP_NUM_PROCESSES", "MASP_PROCESS_ID", "MASP_AUTO_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(D, "_initialized", False)
    assert D.initialize() is False and D.initialize() is False
    assert not D.is_multiprocess() and D.process_count() == 1 and D.process_index() == 0
    assert inspect.signature(D.initialize).parameters["backend"].default == "nccl"

    cpus = ["cpu"] * 8
    mesh = D.pod_mesh(devices=cpus)
    assert mesh.axis_names == ("msm",) and mesh.shape["msm"] == 8 and mesh.local_positions() == list(range(8))
    mesh = D.pod_mesh({"dp": 2, "msm": -1}, devices=cpus)
    assert mesh.shape == {"dp": 2, "msm": 4} and mesh.group(5, "msm") == [4, 5, 6, 7]
    with pytest.raises(ValueError):
        D.pod_mesh({"dp": 9, "msm": -1}, devices=cpus)
    with pytest.raises(ValueError):
        D.pod_mesh({"dp": 7919}, devices=cpus)

    for n_jobs in range(10):
        for pc in range(1, 10):
            for pid in range(pc):
                got = D.local_job_slice(n_jobs, process_id=pid, process_count=pc)
                want = DJ.local_job_slice(n_jobs, process_id=pid, process_count=pc)
                assert (got.start, got.stop, got.global_size, len(got)) == (
                    want.start, want.stop, want.global_size, len(want))
    assert D.local_job_slice(5) == D.JobSlice(0, 5, 5)

    rows = np.arange(4 * 8 * 3, dtype=np.float32).reshape(32, 3)
    arr = _placed(D.global_from_local(D.pod_mesh({"dp": 8}, devices=cpus), "dp", rows), 4)
    assert arr.shape == rows.shape and np.array_equal(PM.gather(arr).numpy(), rows)
    with pytest.raises(ValueError):
        PM.shard(_cpu_mesh(3), torch.zeros(4, 1), "msm")

    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="CUDA devices"):
            PM.make_mesh(2)
    assert PM.make_mesh(4, devices=cpus).shape == {"msm": 4}


def test_two_process_gloo_demo():
    """masp_tpu_torch/tools/distributed_demo.py with 2 processes over gloo
    and 4 CPU positions (2 a process): the job slices, global_from_local,
    the mesh prover with its chunks crossing processes, against the host
    prover on each, and the dp batch's all-gathered proofs through
    verify_proofs_batch. Both workers pass."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "masp_tpu_torch" / "tools" / "distributed_demo.py"), "--nproc", "2",
         "--positions", "4", "--timeout", "420"],
        capture_output=True, text=True, timeout=480, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    assert proc.stdout.count("DISTRIBUTED DEMO PASS") == 2


# --- limbs against the JAX package's sharded MSMs (minutes of XLA compilation) --------

@pytest.mark.slow
def test_sharded_msms_limbs_match_jax():
    """The sharded sorted MSM (G1 c = 8 on 4 positions, G2 c = 4 on 2,
    signed c = 4 on 4), pippenger_msm and sharded_pippenger give the JAX
    package's limbs exactly: the same adds in the same order."""
    points, scalars = _mesh_msm_case()
    packed = _packed(1, points)
    digits = MJ.scalars_to_digits(scalars, 8, 256)
    limbs = F.encode(FR, scalars, mont=False)
    nprng = np.random.default_rng(33)
    pts2 = [HG2.generator() * int(k) for k in nprng.integers(1, 1 << 40, 16)]
    packed2, digits2 = _packed(2, pts2), MJ.scalars_to_digits(scalars[:16], 4, 256)
    for group, pk, dg, c, n, kw in ((1, packed, digits, 8, 4, {}), (2, packed2, digits2, 4, 2, {}),
                                    (1, packed, limbs, 4, 4, {"from_limbs": True, "signed": True})):
        fops, jfops = (W.G1Ops, WJ.G1Ops) if group == 1 else (W.G2Ops, WJ.G2Ops)
        got = PM.gather(PM.sharded_sorted_msm(_cpu_mesh(n), fops, _t(pk), _t(dg), c, axis="msm", **kw))
        jmesh = PMJ.make_mesh(n, axis="msm")
        jgot = jax.jit(lambda a, b: PMJ.sharded_sorted_msm(jmesh, jfops, a, b, c, axis="msm", **kw))(
            jnp.asarray(pk), jnp.asarray(dg))
        assert np.array_equal(got.numpy(), np.concatenate([np.asarray(x).reshape(-1) for x in jgot]).astype(np.int32))
    coords = WJ.encode_g1_points(points)
    d4 = MJ.scalars_to_digits(scalars, 4, 256)
    single = M.pippenger_msm(W.G1Ops, tuple(_t(x) for x in coords), torch.as_tensor(d4), 4, lanes=4)
    jsingle = jax.jit(lambda a, b, c, d: MJ.pippenger_msm(WJ.G1Ops, (a, b, c), d, 4, lanes=4))(
        *(jnp.asarray(x) for x in coords), jnp.asarray(d4))
    assert all(np.array_equal(a.numpy(), np.asarray(b).astype(np.int32)) for a, b in zip(single, jsingle))
    sharded = PM.gather(PM.sharded_pippenger(_cpu_mesh(4), W.G1Ops, tuple(_t(x) for x in coords),
                                             torch.as_tensor(d4), 4, 4, axis="msm"))
    jmesh = PMJ.make_mesh(4, axis="msm")
    jsharded = jax.jit(lambda a, b, c, d: PMJ.sharded_pippenger(jmesh, WJ.G1Ops, (a, b, c), d, 4, 4, axis="msm"))(
        *(jnp.asarray(x) for x in coords), jnp.asarray(d4))
    assert np.array_equal(sharded.numpy(), np.concatenate([np.asarray(x).reshape(-1) for x in jsharded]).astype(np.int32))
