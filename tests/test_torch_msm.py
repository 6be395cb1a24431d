"""Parity of the port's NTT domain, sorted MSM and h quotient with the JAX
package (groth16/domain.py, ops/msm_sorted.py) and the host reference
(groth16/reference.py). Exact equality throughout.

The MSM checks against the JAX functions themselves compile minutes of XLA
on the CPU, so they are marked slow; the default run holds the same outputs
to host bigint sums, on both the batch-affine and the scan ladder."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masp_tpu.curves.bls12_381 import G1 as HG1, G2 as HG2, R
from masp_tpu.groth16 import reference as REF
from masp_tpu.groth16.domain import Domain as JDomain
from masp_tpu.ops import msm_sorted as MSJ
from masp_tpu.ops import weierstrass_jax as WJ
from masp_tpu_torch.groth16 import prover as TP
from masp_tpu_torch.groth16.domain import Domain
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops import msm_sorted as MS
from masp_tpu_torch.ops import weierstrass as W
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

C = 4


@pytest.fixture(params=["affine", "scan"])
def ladder(request, monkeypatch):
    """Both MSM configurations: the batch-affine ladder with the wide
    reduction (the default) and the projective scan ladder. The affine case
    runs one affine level, a quarter of the CPU's root-inverse chains;
    tests/test_torch_affine.py holds the multi-level ladder."""
    monkeypatch.setattr(MS, "AFFINE_LADDER", request.param == "affine")
    monkeypatch.setattr(MS, "AFFINE_LEVELS", 1)
    return request.param


def _fr_vals(n, seed):
    rng = random.Random(seed)
    return [0, 1, R - 1] + [rng.randrange(R) for _ in range(n - 3)]


def _t(arr):
    return torch.as_tensor(np.asarray(arr).astype(np.int32))


def test_ntt_domain_matches_jax():
    m = 64
    dom, jdom = Domain(m, device="cpu"), JDomain(m)
    for inverse in (False, True):
        for s, tw in enumerate(dom._twiddles(inverse)):
            assert np.array_equal(tw.numpy(), jdom._twiddles(inverse)[s].astype(np.int32))
    assert np.array_equal(dom._bitrev().numpy(), jdom._bitrev())
    x = F.encode(F.FR, _fr_vals(m, 1))
    jx = jnp.asarray(x)
    # fft, and icoset_fft (ifft then the g^-i scaling) cover every table
    for name in ("fft", "icoset_fft"):
        want = np.asarray(jax.jit(getattr(jdom, name))(jx)).astype(np.int32)
        assert np.array_equal(getattr(dom, name)(_t(x)).numpy(), want), name
    vals = F.decode(F.FR, x)
    got = dom.divide_by_z_on_coset(dom.coset_fft(_t(x)))
    coset = [v * pow(dom.g, i, R) % R for i, v in enumerate(vals)]
    assert F.decode(F.FR, got) == [v * dom.z_on_coset_inv % R for v in REF._fft(coset, dom.omega)]


def test_ntt_domain_matches_host_at_1024():
    m = 1024
    dom, jdom = Domain(m, device="cpu"), JDomain(m)
    assert np.array_equal(dom._bitrev().numpy(), jdom._bitrev())
    assert np.array_equal(dom._powers(dom.g).numpy(), jdom._powers(jdom.g).astype(np.int32))
    for s in (0, 5, 9):
        assert np.array_equal(dom._twiddles(True)[s].numpy(), jdom._twiddles(True)[s].astype(np.int32))
    vals = _fr_vals(m, 2)
    x = _t(F.encode(F.FR, vals))
    both = torch.stack([x, x.flip(0)])  # two transforms in one batch
    got = dom.fft(both)
    assert F.decode(F.FR, got[0]) == REF._fft(vals, dom.omega)
    assert F.decode(F.FR, got[1]) == REF._fft(vals[::-1], dom.omega)
    assert F.decode(F.FR, dom.ifft(got[0])) == vals


def test_h_pipeline_matches_host_reference():
    m = 256
    vals = [_fr_vals(m - 3, 10 + k) for k in range(3)]
    abc = torch.stack([_t(F.encode(F.FR, v + [0] * 3, mont=False)) for v in vals])
    got = TP.h_pipeline(Domain(m, device="cpu"), abc)
    assert F.decode(F.FR, got) == REF.host_h_from_vals(*vals, m)


def _points(grp, n, seed):
    rng = random.Random(seed)
    g = grp.generator()
    pts = [g * rng.randrange(1, R) for _ in range(n)]
    pts[1] = grp.identity()
    return pts


def _packed(group, pts):
    enc = WJ.encode_g1_points if group == 1 else WJ.encode_g2_points
    coords = enc(pts)
    return np.concatenate([np.asarray(c).reshape(len(pts), -1) for c in coords], axis=1)


def _scalars(n, seed):
    rng = random.Random(seed)
    s = [rng.randrange(R) for _ in range(n)]
    s[0] = 0
    s[2] = R - 1
    return s


def _limbs(scalars):
    return F.encode(F.FR, scalars, mont=False)


def _decode(group, row):
    dec = W.decode_g1_points if group == 1 else W.decode_g2_points
    return dec(*unpack_rows(group, row[None]))[0]


def _port(group, pts):
    enc = WJ.encode_g1_points if group == 1 else WJ.encode_g2_points
    dec = W.decode_g1_points if group == 1 else W.decode_g2_points
    return dec(*enc(pts))


def test_window_buckets_match_host(ladder):
    n = 64
    pts = _points(HG1, n, 3)
    scal = _scalars(n, 4)
    digits = MS.windows_from_limbs(_t(_limbs(scal)), C)
    assert np.array_equal(digits.numpy(), np.asarray(MSJ.windows_from_limbs(jnp.asarray(_limbs(scal)), C)))
    buckets = MS.window_buckets(W.G1Ops, _t(_packed(1, pts)), digits, C)
    nw, B = digits.shape[1], 1 << C
    assert buckets.shape == (nw, B, 72)
    host_pts = _port(1, pts)
    dec = W.decode_g1_points(*unpack_rows(1, buckets.reshape(-1, 72)))
    d = digits.numpy()
    for w in range(0, nw, 7):
        for k in range(B):
            want = type(host_pts[0]).identity()
            for i in np.nonzero(d[:, w] == k)[0]:
                want = want + host_pts[i]
            assert dec[w * B + k] == want, (w, k)


@pytest.mark.parametrize("group,n", [(1, 64), (2, 16)])
def test_sorted_msm_and_masked_sum_match_host(ladder, group, n):
    """G1 runs the whole MSM; G2's bucket reduction is the one the prover
    tests already run, so G2 checks the buckets' total. The masked sum takes
    no ladder option, so only the scan case checks it."""
    grp = HG1 if group == 1 else HG2
    fops = W.G1Ops if group == 1 else W.G2Ops
    pts = _points(grp, n, 5 + group)
    scal = _scalars(n, 6 + group)
    packed = _t(_packed(group, pts))
    want = grp.identity()
    if group == 1:
        got = MS.sorted_msm_from_limbs(fops, packed, _t(_limbs(scal)), C, signed=False)
        for p, s in zip(pts, scal):
            want = want + p * s
    else:  # the lowest window's digit-weighted bucket sum
        buckets = MS.window_buckets(fops, packed, MS.windows_from_limbs(_t(_limbs(scal)), C), C)
        got = buckets[0, 1]
        for p, s in zip(pts, scal):
            if s & 15 == 1:
                want = want + p
    assert _decode(group, got) == _port(group, [want])[0]
    if ladder == "affine":
        return
    bits = torch.as_tensor([s & 1 for s in scal], dtype=torch.int32)
    want_bits = grp.identity()
    for p, b in zip(pts, bits.tolist()):
        if b:
            want_bits = want_bits + p
    assert _decode(group, MS.masked_sum(fops, packed, bits)) == _port(group, [want_bits])[0]


@pytest.mark.parametrize("c", [4, 8])
def test_scan_ladder_wide_reduction_matches_sequential_and_host(monkeypatch, c):
    """On the scan ladder, bucket_reduce_horner's wide form (the reference's
    choice with MASP_MSM_WIDE_REDUCE=1 or from 1,024 buckets) gives the
    sequential form's point and the host's MSM, at c = 4 and c = 8. The
    buckets are the digit classes' sums, added on the host (the ladder's
    own buckets are held above). wide=None takes the wide form under
    WIDE_REDUCE and from 1,024 buckets."""
    monkeypatch.setattr(MS, "AFFINE_LADDER", False)
    n = 64
    pts = _points(HG1, n, 20 + c)
    scal = _scalars(n, 21 + c)
    digits = MS.windows_from_limbs(_t(_limbs(scal)), c).numpy()
    nw, B = digits.shape[1], 1 << c
    sums = [[HG1.identity()] * B for _ in range(nw)]
    for i, p in enumerate(pts):
        for w in range(nw):
            sums[w][digits[i, w]] = sums[w][digits[i, w]] + p
    buckets = _t(_packed(1, [b for row in sums for b in row])).reshape(1, nw, B, 72)
    wide = MS.bucket_reduce_horner(W.G1Ops, buckets, c, wide=True)[0]
    seq = MS.bucket_reduce_horner(W.G1Ops, buckets, c, wide=False)[0]
    want = HG1.identity()
    for p, s in zip(pts, scal):
        want = want + p * s
    assert _decode(1, wide) == _decode(1, seq) == _port(1, [want])[0]

    class Wide(Exception):
        pass

    def chosen(fops, buckets):
        raise Wide

    monkeypatch.setattr(MS, "_window_sums_wide", chosen)
    monkeypatch.setattr(MS, "WIDE_REDUCE", True)
    with pytest.raises(Wide):
        MS.bucket_reduce_horner(W.G1Ops, buckets, c)
    monkeypatch.setattr(MS, "WIDE_REDUCE", False)
    with pytest.raises(Wide):
        MS.bucket_reduce_horner(W.G1Ops, buckets[:, :1, :1].expand(1, 1, 1024, 72), c)


@pytest.mark.slow
def test_msm_limbs_match_jax(monkeypatch):
    """Bucket limbs, MSM result limbs and masked-sum limbs of the scan
    ladder equal the JAX functions' (minutes of XLA compilation on the CPU).
    The port is pinned to the scan ladder, which the reference's compact
    impl runs; tests/test_torch_affine.py holds the affine ladder."""
    monkeypatch.setattr(MS, "AFFINE_LADDER", False)
    n = 64
    pts = _points(HG1, n, 8)
    scal = _scalars(n, 9)
    packed = _packed(1, pts)
    limbs = _limbs(scal)
    jd = MSJ.windows_from_limbs(jnp.asarray(limbs), C)
    jb = jax.jit(lambda p, d: MSJ.window_buckets(WJ.G1Ops, p, d, C))(jnp.asarray(packed), jd)
    tb = MS.window_buckets(W.G1Ops, _t(packed), MS.windows_from_limbs(_t(limbs), C), C)
    assert np.array_equal(tb.numpy(), np.asarray(MSJ.pack_points(tuple(
        x.reshape((-1,) + x.shape[2:]) for x in jb))).reshape(tb.shape).astype(np.int32))
    jm = jax.jit(lambda p, s: MSJ.sorted_msm_from_limbs(WJ.G1Ops, p, s, C, signed=False))(
        jnp.asarray(packed), jnp.asarray(limbs))
    tm = MS.sorted_msm_from_limbs(W.G1Ops, _t(packed), _t(limbs), C, signed=False)
    assert np.array_equal(tm.numpy(), np.concatenate([np.asarray(x) for x in jm]).astype(np.int32))
    bits = np.asarray([s & 1 for s in scal], dtype=np.int8)
    js = jax.jit(lambda p, b: MSJ.masked_sum(WJ.G1Ops, p, b))(jnp.asarray(packed), jnp.asarray(bits))
    ts = MS.masked_sum(W.G1Ops, _t(packed), torch.as_tensor(bits))
    assert np.array_equal(ts.numpy(), np.concatenate([np.asarray(x) for x in js]).astype(np.int32))
