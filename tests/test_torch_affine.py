"""The port's batch-affine MSM ladder (kernels/affine.py, both groups; the
affine helpers, window_buckets_flat and the wide bucket_reduce_horner of
ops/msm_sorted.py) against the host group law, compared exactly: this is
integer arithmetic. On CPU tensors every kernel wrapper runs its plain
version. G2 inverts its Fq2 denominators through their norms to Fq, with the
same Fq product tree as G1.

The limb comparisons with the JAX package's _affine_level and
window_buckets_flat run its eager or jitted compact impl for 20-30 s even at
64 lanes, so they are marked slow. An affine node is canonical, so equality
with the host encoding is limb equality with the reference's nodes too."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masp_tpu.curves.bls12_381 import G1 as HG1, G2 as HG2, R
from masp_tpu.fields import FQ_MODULUS as Q
from masp_tpu.ops import msm_sorted as MSJ
from masp_tpu.ops import weierstrass_jax as WJ
from masp_tpu_torch.kernels import LAUNCHES
from masp_tpu_torch.kernels import affine as AK
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops import msm_sorted as MS
from masp_tpu_torch.ops import weierstrass as W
from masp_tpu_torch.ops.field import FQ
from masp_tpu_torch.ops.projective import unpack_rows


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under pytest-xdist, workers share the CPU: one intra-op thread each
    keeps torch's thread pools from oversubscribing it."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GROUPS = {1: (HG1, W.G1Ops, WJ.G1Ops), 2: (HG2, W.G2Ops, WJ.G2Ops)}


def _xy(group, p):
    """A host point's affine coordinates as Fq ints (c0, c1 on G2)."""
    if group == 1:
        return [p.x.n], [p.y.n]
    return [p.x.c0, p.x.c1], [p.y.c0, p.y.c1]


def _aff_rows(group, points, decoys=()):
    """(n, 2k+1) int32 affine rows [x | y | f] of host points: identity as
    (0, mont-1) with f = 1, or, at the lanes in ``decoys``, f = 1 over the
    coordinates of an unrelated point (the pre kernel allows any)."""
    xs, ys, fs = [], [], []
    for i, p in enumerate(points):
        if p.is_identity():
            q = points[0] if i in decoys else None
            x, y = _xy(group, q) if q is not None else ([0] * group, [1] + [0] * (group - 1))
            fs.append(1)
        else:
            x, y = _xy(group, p)
            fs.append(0)
        xs.append(x)
        ys.append(y)
    enc = [F.encode(FQ, [v for row in c for v in row]).reshape(len(points), -1) for c in (xs, ys)]
    return torch.as_tensor(np.concatenate(enc + [np.asarray(fs)[:, None]], axis=1).astype(np.int32))


def _level_case(grp, n, seed):
    """n lane pairs: doubling, P + (-P), identity + P, P + identity,
    identity + identity, a flagged lane over unrelated coordinates, and
    random chords; returns (P1, P2, decoy lanes)."""
    rng = random.Random(seed)
    g = grp.generator()
    p1 = [g * rng.randrange(1, 1 << 62) for _ in range(n)]
    p2 = [g * rng.randrange(1, 1 << 62) for _ in range(n)]
    for i in range(n):
        case = i % 8
        if case == 0:
            p2[i] = p1[i]
        elif case == 1:
            p2[i] = -p1[i]
        elif case in (2, 5):
            p1[i] = grp.identity()
        elif case == 3:
            p2[i] = grp.identity()
        elif case == 4:
            p1[i] = p2[i] = grp.identity()
    return p1, p2, {i for i in range(n) if i % 8 == 5}


# case codes of _level_case's lanes: bit 0 P1 = O, bit 1 P2 = O, bit 2
# P + (-P), bit 3 doubling
LEVEL_CODES = [8, 4, 1, 2, 3, 1, 0, 0]


@pytest.mark.parametrize("group", [1, 2])
def test_affine_level_matches_host(group):
    """One affine level at 64 lanes through affine_pre_plain -> the Fq
    product tree over d's norms -> affine_post_plain, on G1 and on G2, with
    the same case code lane for lane."""
    grp = GROUPS[group][0]
    p1, p2, decoys = _level_case(grp, 64, 40 + group)
    r1 = _aff_rows(group, p1, decoys)
    r2 = _aff_rows(group, p2, {i - 2 for i in decoys})  # lanes 3 mod 8: P + identity
    want = _aff_rows(group, [a + b for a, b in zip(p1, p2)])
    n, norm, code = AK.affine_pre_plain(r1, r2)
    assert n.shape == (64, 24 * group) and norm.shape == (64, 24)
    got = AK.affine_post_plain(n, F.tree_batch_inv(FQ, norm), r1, r2, code)
    assert code.tolist() == [LEVEL_CODES[i % 8] for i in range(64)]
    assert torch.equal(got, want)
    assert torch.equal(AK.affine_level(r1, r2), want)


def _fq2_inv(c0, c1):
    ni = pow(c0 * c0 + c1 * c1, -1, Q)
    return c0 * ni % Q, -c1 * ni % Q


@pytest.mark.parametrize("group", [1, 2])
def test_tree_batch_inv_and_root_inv_match_host(group):
    """The affine levels' inversion of their denominators d (Fq on G1, Fq2
    on G2) through d's norm: the Fq product tree over 16 norms, and one
    root's Fermat inversion, then d^-1 from the norm's inverse."""
    rng = random.Random(50 + group)
    fops = GROUPS[group][1]
    vals = [[rng.randrange(1, Q) for _ in range(group)] for _ in range(16)]
    vals[3] = [1] + [0] * (group - 1)
    vals[5] = [Q - 1] + [0] * (group - 1)
    d = torch.as_tensor(F.encode(FQ, [v for row in vals for v in row]).astype(np.int32))
    d = d.reshape(16, group, FQ.L)
    inv = [pow(v[0], -1, Q) for v in vals] if group == 1 else [_fq2_inv(*v) for v in vals]
    want = fops.encode(inv).reshape(16, -1).astype(np.int32)
    got = AK._inv_from_norm(d, F.tree_batch_inv(FQ, AK._norm(d)))
    assert np.array_equal(got.reshape(16, -1).numpy(), want)
    root = AK._inv_from_norm(d[2:3], F.mont_inv_small(FQ, AK._norm(d[2:3])))
    assert np.array_equal(root.reshape(1, -1).numpy(), want[2:3])


def test_non_power_of_two_lane_count_raises():
    d = torch.as_tensor(F.encode(FQ, list(range(1, 13))).astype(np.int32))
    with pytest.raises(ValueError, match="power-of-two lane count"):
        F.tree_batch_inv(FQ, d)
    with pytest.raises(ValueError, match="power-of-two lane count"):
        AK.affine_level_plain(*_aff_rows(1, [HG1.generator()] * 24).reshape(2, 12, -1))
    # c = 10: 26 windows of 4 points, 104 lanes
    pts = W.encode_g1_points([HG1.generator()] * 4)
    packed = torch.as_tensor(np.concatenate([c.reshape(4, -1) for c in pts], axis=1).astype(np.int32))
    digits = torch.zeros((4, MS.n_windows_for(10)), dtype=torch.int64)
    with pytest.raises(ValueError, match="power-of-two lane count"):
        MS.window_buckets_flat(W.G1Ops, packed, digits, 10)


def test_affine_wrappers_check_inputs():
    rows = _aff_rows(1, [HG1.generator()] * 4)
    rows2 = _aff_rows(2, [HG2.generator()] * 4)
    with pytest.raises(ValueError):
        AK.affine_pre(rows[:, :48], rows)
    with pytest.raises(ValueError):
        AK.affine_pre(rows, rows[:3])
    with pytest.raises(ValueError):
        AK.affine_pre(rows, rows2)  # G1 and G2 rows
    n, d, code = AK.affine_pre(rows, rows)
    with pytest.raises(ValueError):
        AK.affine_post(n, d, rows, rows, code.to(torch.int64))
    with pytest.raises(ValueError):
        AK.affine_post(n[:3], d, rows, rows, code)
    with pytest.raises(ValueError):
        AK.affine_post(n, d, rows2, rows2, code)  # a G1 n for G2 rows
    n2, d2, code2 = AK.affine_pre(rows2, rows2)
    before = dict(LAUNCHES)
    AK.affine_post(n, d, rows, rows, code)
    AK.affine_post(n2, d2, rows2, rows2, code2)
    assert LAUNCHES == before  # the plain versions ran: no launch counted


@pytest.mark.cuda
def test_affine_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for group in (1, 2):
        p1, p2, decoys = _level_case(GROUPS[group][0], 256, 90)
        r1, r2 = _aff_rows(group, p1, decoys).cuda(), _aff_rows(group, p2).cuda()
        pairs = torch.cat([r1, r2], dim=1)  # strided operands, as the ladder passes them
        row = r1.shape[1]
        a, b = pairs[:, :row], pairs[:, row:]
        pre = AK.affine_pre(a, b)
        for got, want in zip(pre, AK.affine_pre_plain(r1, r2)):
            assert torch.equal(got, want)
        inv = F.tree_batch_inv(FQ, pre[1])
        assert torch.equal(AK.affine_post(pre[0], inv, a, b, pre[2]),
                           AK.affine_post_plain(pre[0], inv, r1, r2, pre[2]))
        assert torch.equal(AK.affine_level(a, b), AK.affine_level_plain(r1, r2))


def _msm_case(grp, n, seed):
    """Points with doubling pairs, P and -P, identity pads and a zero scalar;
    equal scalars keep the special pairs adjacent in every window's sorted
    order (the sort is stable)."""
    rng = random.Random(seed)
    g = grp.generator()
    pts = [g * rng.randrange(1, 1 << 62) for _ in range(n)]
    pts[1] = pts[0]
    pts[3] = -pts[2]
    pts[5] = pts[6] = pts[8] = grp.identity()
    scal = [rng.randrange(R) for _ in range(n)]
    scal[1], scal[3], scal[6] = scal[0], scal[2], scal[5]
    scal[10] = 0
    return pts, scal


def _packed(group, pts):
    enc = WJ.encode_g1_points if group == 1 else WJ.encode_g2_points
    return np.concatenate([np.asarray(c).reshape(len(pts), -1) for c in enc(pts)], axis=1)


def _limbs(scal):
    return F.encode(F.FR, scal, mont=False)


def _t(arr):
    return torch.as_tensor(np.asarray(arr).astype(np.int32))


@pytest.mark.parametrize("group,n,levels", [(1, 64, 16), (2, 16, 4)])
def test_flat_msm_matches_host(group, n, levels, monkeypatch):
    """window_buckets_flat + the wide reduction: the whole MSM at c = 4 against
    the host sum. G1 forces every level affine (AFFINE_LEVELS clamped to
    the depth, 6); G2 runs the default 4, which is its depth."""
    monkeypatch.setattr(MS, "AFFINE_LADDER", True)
    monkeypatch.setattr(MS, "AFFINE_LEVELS", levels)
    grp, fops, _ = GROUPS[group]
    pts, scal = _msm_case(grp, n, 60 + group)
    digits = MS.windows_from_limbs(_t(_limbs(scal)), 4)
    buckets = MS.window_buckets_flat(fops, _t(_packed(group, pts)), digits, 4)
    got = MS.bucket_reduce_horner(fops, buckets[None], 4)[0]
    want = grp.identity()
    for p, s in zip(pts, scal):
        want = want + p * s
    dec = W.decode_g1_points if group == 1 else W.decode_g2_points
    assert _xy(group, dec(*unpack_rows(group, got[None]))[0]) == _xy(group, want)


@pytest.mark.slow
@pytest.mark.parametrize("group", [1, 2])
def test_affine_level_limbs_match_jax(group):
    grp, fops, jfops = GROUPS[group]
    p1, p2, decoys = _level_case(grp, 64, 70 + group)
    r1, r2 = _aff_rows(group, p1, decoys), _aff_rows(group, p2)

    k, shape = 24 * group, (64,) + tuple(fops.coord_shape)

    def jax_coords(rows):
        x, y, f = rows[:, :k].reshape(shape), rows[:, k : 2 * k].reshape(shape), rows[:, 2 * k]
        return jnp.asarray(x.numpy().astype(np.uint32)), jnp.asarray(y.numpy().astype(np.uint32)), jnp.asarray(f.numpy())

    jx, jy, jf = MSJ._affine_level(jfops, jax_coords(r1), jax_coords(r2))
    want = torch.cat([_t(jx).reshape(64, -1), _t(jy).reshape(64, -1), _t(jf).reshape(64, 1)], dim=1)
    assert torch.equal(AK.affine_level(r1, r2), want)


@pytest.mark.slow
def test_flat_buckets_and_msm_limbs_match_jax(monkeypatch):
    """Bucket and MSM limbs of the flat ladder equal the JAX package's, the
    affine ladder forced on both sides (the reference's compact impl keeps
    the scan ladder by default)."""
    monkeypatch.setattr(MSJ, "AFFINE_LADDER", True)
    monkeypatch.setattr(MS, "AFFINE_LADDER", True)
    pts, scal = _msm_case(HG1, 64, 80)
    packed, limbs = _packed(1, pts), _limbs(scal)
    jd = MSJ.windows_from_limbs(jnp.asarray(limbs), 4)
    jb = jax.jit(lambda p, d: MSJ.window_buckets(WJ.G1Ops, p, d, 4))(jnp.asarray(packed), jd)
    tb = MS.window_buckets(W.G1Ops, _t(packed), MS.windows_from_limbs(_t(limbs), 4), 4)
    assert np.array_equal(tb.numpy(), np.asarray(MSJ.pack_points(tuple(
        x.reshape((-1,) + x.shape[2:]) for x in jb))).reshape(tb.shape).astype(np.int32))
    jm = jax.jit(lambda p, s: MSJ.sorted_msm_from_limbs(WJ.G1Ops, p, s, 4, signed=False))(
        jnp.asarray(packed), jnp.asarray(limbs))
    tm = MS.sorted_msm_from_limbs(W.G1Ops, _t(packed), _t(limbs), 4, signed=False)
    assert np.array_equal(tm.numpy(), np.concatenate([np.asarray(x) for x in jm]).astype(np.int32))
