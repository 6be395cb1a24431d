"""The port's device pairing (masp_tpu_torch/ops/pairing.py) against the JAX
package's (masp_tpu/ops/pairing_jax.py) and the host pairing
(masp_tpu_torch/host/bls12_381.py), on the CPU. Every comparison is exact:
the device values are designed to be the host's elements, not only the same
pairing class.

The full final exponentiation through the port's plain CPU arithmetic is
about 1,900 Fq12 products, so the CPU checks its parts (the easy part, the
square-and-multiply helper) and chip_smoke.py's pairing phase holds the
whole pipeline against the host on the card. The JAX package's f12inv takes
about 40 s of XLA compilation here, so the inversions are held against the
JAX package at the Fq and Fq2 levels and the Fq12 inverse against the host's
(it is unique)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masp_tpu.curves import bls12_381 as JB
from masp_tpu.ops import field_jax as JF
from masp_tpu.ops import pairing_jax as PJ
from masp_tpu.ops import weierstrass_jax as WJ
from masp_tpu_torch.host import bls12_381 as HB
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops import pairing as P
from masp_tpu_torch.ops import weierstrass as W


def _rand_ints(rng, n):
    return [rng.randrange(HB.Q) for _ in range(n)]


def _fq12(B, ints):
    """An Fq12 of either package's host classes from 12 ints (c0 then c1 of
    each Fq2, Fq2s in tower order)."""
    f2 = [B.Fq2(ints[2 * i], ints[2 * i + 1]) for i in range(6)]
    return B.Fq12(B.Fq6(*f2[:3]), B.Fq6(*f2[3:]))


def _ints(f):
    return [c for f6 in (f.c0, f.c1) for x in (f6.c0, f6.c1, f6.c2) for c in (x.c0, x.c1)]


def _first(f):
    return P._fq12_map(lambda x: x[0], f)


def test_tower_ops_match_jax_and_host():
    """f12mul, f12sq, f12conj, f12inv and f12frobenius2 on two random Fq12
    values equal pairing_jax's (under jax.jit) and the host's; the Fq2
    inversion (Fq2Ops.inv, through the inversion kernel's plain version) and
    the batch inversion, a zero lane included, equal the JAX package's."""
    rng = random.Random(31)
    ai, bi = _rand_ints(rng, 12), _rand_ints(rng, 12)
    a, b = _fq12(HB, ai), _fq12(HB, bi)
    da, db = P.encode_fq12(a, device="cpu"), P.encode_fq12(b, device="cpu")
    ja, jb = PJ.encode_fq12(_fq12(JB, ai)), PJ.encode_fq12(_fq12(JB, bi))
    jmul = jax.jit(PJ.f12mul)
    want = {
        "mul": (P.f12mul(da, db), jmul(ja, jb), a * b),
        "sq": (P.f12sq(da), jmul(ja, ja), a * a),
        "conj": (P.f12conj(da), jax.jit(PJ.f12conj)(ja), a.conjugate()),
        "frobenius2": (P.f12frobenius2(da), jax.jit(PJ.f12frobenius2)(ja), a.frobenius().frobenius()),
    }
    for name, (got, jgot, host) in want.items():
        assert _ints(P.decode_fq12(got)) == _ints(PJ.decode_fq12(jgot)) == _ints(host), name
    inv = a.invert()
    assert inv is not None and P.decode_fq12(P.f12inv(da)) == inv
    assert P.decode_fq12(P.f12mul(P.f12inv(da), da)) == HB.Fq12.one()

    # the Fq2 inversion and the batch inversions, zero lanes included
    vals = [(0, 0), (1, 0), (0, 1)] + [tuple(_rand_ints(rng, 2)) for _ in range(3)]
    x = W.Fq2Ops.encode(vals)
    got = W.Fq2Ops.inv(torch.as_tensor(x.astype(np.int32)))
    jgot = jax.jit(WJ.Fq2Ops.inv)(jnp.asarray(x))
    assert W.Fq2Ops.decode(got) == WJ.Fq2Ops.decode(jgot)
    assert W.Fq2Ops.decode(got)[0] == (0, 0)
    for (c0, c1), y in zip(vals[1:], W.Fq2Ops.decode(got)[1:]):
        assert HB.Fq2(c0, c1) * HB.Fq2(*y) == HB.Fq2(1, 0)
    rows = x.reshape(-1, F.FQ.L)  # 12 Fq rows, zeros among them
    got = F.batch_mont_inv(F.FQ, torch.as_tensor(rows.astype(np.int32)))
    jgot = jax.jit(lambda r: JF.batch_mont_inv(JF.FQ, r))(jnp.asarray(rows))
    assert np.array_equal(got.numpy(), np.asarray(jgot).astype(np.int32))
    assert F.decode(F.FQ, got) == [pow(v, -1, HB.Q) if v else 0 for v in F.decode(F.FQ, rows)]


def test_miller_loop_matches_host():
    """multi_miller_loop_device on 2 random non-identity pairs is the host's
    multi_miller_loop: the same element."""
    rng = random.Random(32)
    pairs = [(HB.G1.generator() * rng.randrange(1, HB.R), HB.G2.generator() * rng.randrange(1, HB.R))
             for _ in range(2)]
    f = P.multi_miller_loop_device(*P.encode_pairs(pairs, device="cpu"))
    assert f[0][0].shape == (1, 2, F.FQ.L)
    assert P.decode_fq12(_first(f)) == HB.multi_miller_loop(pairs)


def test_final_exponentiation_parts_match_host():
    """The easy part on a random Fq12 is the host's f^((q^6 - 1)(q^2 + 1));
    the square-and-multiply helper over a 64-bit exponent is the host's pow,
    from one and from an accumulator; the hard exponent's bits start with a
    set bit, which final_exponentiation_device relies on."""
    rng = random.Random(34)
    a = _fq12(HB, _rand_ints(rng, 12))
    da = P.encode_fq12(a, device="cpu")
    assert P.decode_fq12(P._easy_part(da)) == HB._easy_part(a)
    e = rng.getrandbits(64) | 1 << 63
    bits = [int(c) for c in bin(e)[2:]]
    assert P.decode_fq12(P._hard_chunk(P.f12one(da[0][0]), da, bits)) == a.pow(e)
    assert P.decode_fq12(P._hard_chunk(da, da, bits[1:])) == a.pow(e)
    d = (HB.Q**4 - HB.Q**2 + 1) // HB.R
    assert P._hard_exp_bits()[0] == 1 and int("".join(map(str, P._hard_exp_bits())), 2) == d


def test_entry_point_filters_identities_and_takes_the_card(monkeypatch):
    """pairing_product_is_one_device: an identity-only list is True with no
    device work; device "cuda" raises without a card, never falling back to
    the CPU."""
    def no_device_work(*args):
        raise AssertionError("the device pipeline ran")

    monkeypatch.setattr(P, "multi_miller_loop_device", no_device_work)
    q = HB.G2.generator() * 5
    assert P.pairing_product_is_one_device([(HB.G1.identity(), q), (HB.G1.generator(), HB.G2.identity())],
                                           device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        P.pairing_product_is_one_device([(HB.G1.generator(), q)])
