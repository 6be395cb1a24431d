"""The port's Jubjub and Pedersen twins (masp_tpu_torch.ops.jubjub and
ops.pedersen) against the JAX package's (masp_tpu.ops.jubjub_jax and
pedersen_jax) on the CPU, where the kernels' wrappers run their plain
versions: projective limbs, decoded points and bytes equal, tolerance 0.
Inputs come from seeded ``random`` and numpy generators, the JAX tests'
cases among them (tests/test_jubjub_jax.py, tests/test_pedersen_jax.py).
The copied FrozenCommitmentTree and redjubjub.batch_verify reach the twins
through their device routes, with the twins asked for the CPU."""

import random
from functools import partial

import numpy as np
import torch

from masp_tpu.curves.jubjub import ExtendedPoint as JExtendedPoint
from masp_tpu.fields import SCALAR_MODULUS
from masp_tpu.fields import JubjubFr as JJubjubFr
from masp_tpu.fields import Scalar as JScalar
from masp_tpu.ops import field_jax as JF
from masp_tpu.ops import jubjub_jax as JJ
from masp_tpu.ops import pedersen_jax as JP
from masp_tpu.primitives import redjubjub as JRJ
from masp_tpu.primitives.constants import spending_key_generator as jspending_key_generator
from masp_tpu.primitives.merkle_tree import FrozenCommitmentTree as JFrozenCommitmentTree
from masp_tpu.primitives.pedersen import Personalization as JPersonalization
from masp_tpu.primitives.sapling import Node as JNode
from masp_tpu.utils.rng import XorShiftRng as JXorShiftRng
from masp_tpu_torch.host.fields import JubjubFr
from masp_tpu_torch.host.jubjub import ExtendedPoint
from masp_tpu_torch.host.primitives import redjubjub as RJ
from masp_tpu_torch.host.primitives.constants import spending_key_generator
from masp_tpu_torch.host.primitives.merkle_tree import FrozenCommitmentTree
from masp_tpu_torch.host.primitives.pedersen import Personalization
from masp_tpu_torch.host.primitives.sapling import Node
from masp_tpu_torch.host.rng import XorShiftRng
from masp_tpu_torch.ops import jubjub as J
from masp_tpu_torch.ops import pedersen as P
from tests.test_torch_prover import _one_torch_thread  # noqa: F401 (autouse fixture)

Q_JUB = JubjubFr.META.modulus


def _port_point(p) -> ExtendedPoint:
    """A JAX-package point as the port's, through its encoding."""
    return ExtendedPoint.from_bytes(p.to_bytes())


def _jax_points(rng, n):
    return [jspending_key_generator() * JJubjubFr(rng.randrange(1, Q_JUB)) for _ in range(n)]


def _small_order():
    return JExtendedPoint.from_affine(JScalar(0), JScalar(SCALAR_MODULUS - 1))


def _coords(arrs):
    return tuple(torch.as_tensor(np.asarray(a).astype(np.int32)) for a in arrs)


def _limbs(t):
    return np.asarray(t).astype(np.int64)


def test_edwards_add_matches_jax():
    """JubjubOps.add_points on the JAX test's batch (generic, P + P, P + (-P),
    O + P, small order): the same projective limbs."""
    import jax.numpy as jnp

    rng = random.Random(71)
    ps = _jax_points(rng, 4)
    qs = _jax_points(rng, 4)
    ps += [ps[0], ps[1], JExtendedPoint.identity(), _small_order()]
    qs += [ps[0], -ps[1], ps[2], _small_order()]
    want = JJ.JubjubOps.add_points(*(tuple(jnp.asarray(x) for x in JJ.encode_points(pts)) for pts in (ps, qs)))
    got = J.JubjubOps.add_points(*(_coords(J.encode_points([_port_point(p) for p in pts])) for pts in (ps, qs)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_limbs(g), _limbs(w))
    assert J.decode_points(*got) == [_port_point(p + q) for p, q in zip(ps, qs)]


def test_msm_and_batch_verify_match_jax(monkeypatch):
    """msm of 13 points with a zero scalar and an identity point; the device
    batch verifier on 4 good signatures, on one corrupted (against the JAX
    twin, whose MSM runs eagerly on the CPU at about 27 s a call) and on
    none; the good batch's verdict against the JAX package's host batch
    verifier; the copied redjubjub.batch_verify's device route reaches the
    twin."""
    rng = random.Random(72)
    points = _jax_points(rng, 13)
    scalars = [rng.randrange(Q_JUB) for _ in range(13)]
    scalars[0] = 0
    points[1] = JExtendedPoint.identity()
    got = J.msm([_port_point(p) for p in points], scalars, device="cpu")
    assert got == _port_point(JJ.msm(points, scalars))
    assert J.msm([], [], device="cpu") == ExtendedPoint.identity()

    p_g, jp_g = spending_key_generator(), jspending_key_generator()
    keys = random.Random(75)

    class _Bytes:
        def fill_bytes(self, n):
            return keys.randbytes(n)

    entries, jentries = [], []
    for i in range(4):
        sk = RJ.PrivateKey(JubjubFr(keys.randrange(1, Q_JUB)))
        msg = f"msg-{i}".encode()
        sig = sk.sign(msg, _Bytes(), p_g)
        vk = RJ.PublicKey.from_private(sk, p_g)
        entries.append(RJ.BatchEntry(vk=vk, msg=msg, sig=sig))
        jentries.append(JRJ.BatchEntry(vk=JRJ.PublicKey(JExtendedPoint.from_bytes(vk.point.to_bytes())),
                                       msg=msg, sig=JRJ.Signature(sig.rbar, sig.sbar)))
    bad, jbad = list(entries), list(jentries)
    s = bytearray(bad[2].sig.sbar)
    s[0] ^= 1
    bad[2] = RJ.BatchEntry(vk=bad[2].vk, msg=bad[2].msg, sig=RJ.Signature(bad[2].sig.rbar, bytes(s)))
    jbad[2] = JRJ.BatchEntry(vk=jbad[2].vk, msg=jbad[2].msg, sig=JRJ.Signature(jbad[2].sig.rbar, bytes(s)))
    seed = b"\x05" * 16
    assert J.batch_verify_device(XorShiftRng.from_seed(seed), entries, p_g, device="cpu")
    assert JRJ.batch_verify(JXorShiftRng.from_seed(seed), jentries, jp_g)
    assert not J.batch_verify_device(XorShiftRng.from_seed(seed), bad, p_g, device="cpu")
    assert not JJ.batch_verify_device(JXorShiftRng.from_seed(seed), jbad, jp_g)
    assert J.batch_verify_device(XorShiftRng.from_seed(seed), [], p_g, device="cpu")

    calls, twin = [], J.batch_verify_device

    def on_cpu(rng, batch, p_g):
        calls.append(len(batch))
        return twin(rng, batch, p_g, device="cpu")

    monkeypatch.setattr(J, "batch_verify_device", on_cpu)
    assert RJ.batch_verify(XorShiftRng.from_seed(b"\x06" * 16), entries, p_g, use_device=True)
    assert calls == [4]


def test_sqrt_and_decompression_match_jax():
    """batch_sqrt's roots and flags on 16 values (0 and 1 among them) and
    on values of every 2-adic order, which drive each Tonelli-Shanks branch
    (z^(2^k) c^2 for k = 1 .. 32, non-squares z^odd c^2, 0, 1 and -1:
    chip_smoke._two_adic_values), against the JAX batch_sqrt and host
    ints; and batch_from_bytes on the JAX test's 14 items, ZIP-216 on and
    off."""
    import jax.numpy as jnp

    import chip_smoke

    rng = random.Random(73)
    vals = [rng.randrange(SCALAR_MODULUS) for _ in range(14)] + [0, 1] + chip_smoke._two_adic_values(seed=75)
    enc = JF.encode(JF.FR, vals)
    roots, ok = J.batch_sqrt(torch.as_tensor(enc.astype(np.int32)))
    jroots, jok = JJ.batch_sqrt(jnp.asarray(enc))
    np.testing.assert_array_equal(_limbs(roots), _limbs(jroots))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.sum() not in (0, len(vals))
    for v, r, k in zip(vals, JF.decode(JF.FR, _limbs(roots)), ok.tolist()):
        assert k == (v == 0 or pow(v, (SCALAR_MODULUS - 1) // 2, SCALAR_MODULUS) == 1)
        assert not k or r * r % SCALAR_MODULUS == v

    rng = random.Random(74)
    items = [_port_point(p).to_bytes() for p in _jax_points(rng, 8)]
    items.append(ExtendedPoint.identity().to_bytes())
    items.append(_small_order().to_bytes())
    items.append((SCALAR_MODULUS + 1).to_bytes(32, "little"))
    neg_zero = bytearray(ExtendedPoint.identity().to_bytes())
    neg_zero[31] |= 0x80
    items.append(bytes(neg_zero))
    bad = bytearray(items[0])
    while ExtendedPoint.from_bytes(bytes(bad)) is not None:
        bad[0] = (bad[0] + 1) & 0xFF
    items.append(bytes(bad))
    items.append(b"\x00" * 31)
    for zip216 in (True, False):
        got = J.batch_from_bytes(items, zip216, device="cpu")
        want = JJ.batch_from_bytes(items, zip216)
        assert [None if g is None else g.to_bytes() for g in got] == [
            None if w is None else w.to_bytes() for w in want]
        assert (got[11] is None) == zip216 and got[-1] is None and got[0] is not None
    assert J.batch_from_bytes([], device="cpu") == []


def test_pedersen_matches_jax():
    """For 6, 183, 189, 254 and 510 bits (within one generator segment,
    exactly one, two, three): the chunk table's limbs and the hash points'
    projective limbs, all-zero and all-one inputs among them; then
    batch_merkle_hash's bytes at depths 0 and 13."""
    rng = random.Random(81)
    pers, jpers = Personalization.note_commitment(), JPersonalization.note_commitment()
    for nbits in (6, 183, 189, 254, 510):
        rows = np.asarray([[rng.random() < 0.5 for _ in range(nbits)] for _ in range(5)]
                          + [[False] * nbits, [True] * nbits], dtype=bool)
        C = -(-(nbits + 6) // 3)
        want = np.concatenate([_limbs(a) for a in JP._chunk_tables(C)], axis=-1)
        np.testing.assert_array_equal(_limbs(P._chunk_tables(C, "cpu")), want)
        got = P.batch_pedersen_hash_points(pers, rows, device="cpu")
        for g, w in zip(got, JP.batch_pedersen_hash_points(jpers, rows)):
            np.testing.assert_array_equal(_limbs(g), _limbs(w))
    pairs = [(rng.randrange(1 << 255).to_bytes(32, "little"),
              rng.randrange(1 << 255).to_bytes(32, "little")) for _ in range(6)]
    for depth in (0, 13):
        assert P.batch_merkle_hash(depth, pairs, device="cpu") == JP.batch_merkle_hash(depth, pairs)
    assert P.batch_merkle_hash(0, [], device="cpu") == []


def test_frozen_tree_device_route_matches_jax(monkeypatch):
    """The copied FrozenCommitmentTree.new of 11 leaves with the device route
    from 2 pairs a level, the twin on the CPU: the JAX package's tree."""
    rng = random.Random(84)
    raw = [rng.randrange(1 << 255).to_bytes(32, "little") for _ in range(11)]
    monkeypatch.setenv("MASP_MERKLE_DEVICE_MIN", "2")
    monkeypatch.setattr(P, "batch_merkle_hash", partial(P.batch_merkle_hash, device="cpu"))
    got = FrozenCommitmentTree.new([Node(r) for r in raw])
    want = JFrozenCommitmentTree.new([JNode(r) for r in raw])
    assert [n.repr for n in got.nodes] == [n.repr for n in want.nodes]
    assert got.root().repr == want.root().repr and got.size() == want.size() == 11
