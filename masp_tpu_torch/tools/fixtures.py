# Copies of _spend_fixture, _convert_fixture and _output_fixture from bench.py,
# verbatim apart from import paths; the port imports nothing of masp_tpu.
"""Seeded instances of the Spend, Output and Convert circuits, as bench.py
builds them: each fixture returns (make_circuit, public_inputs), where
make_circuit() gives a fresh circuit instance with its full witness.
``fixture(kind)`` seeds an XorShiftRng with bench.py's seed, so its instance
equals the one bench.py proves."""

from __future__ import annotations

from masp_tpu_torch.host.rng import XorShiftRng

BENCH_SEED = bytes(range(16))


def _spend_fixture(rng):
    from masp_tpu_torch.host.circuits.sapling import Spend
    from masp_tpu_torch.host.fields import Scalar
    from masp_tpu_torch.groth16.public_inputs import spend_public_inputs
    from masp_tpu_torch.host.primitives.asset_type import AssetType
    from masp_tpu_torch.host.primitives.keys import ExpandedSpendingKey
    from masp_tpu_torch.host.primitives.sapling import Diversifier, Note, Rseed, merkle_hash
    from masp_tpu_torch.host.rng import random_jubjub_fr

    asset_type = AssetType.new(b"default")
    value = 1234567
    rcv = random_jubjub_fr(rng)
    value_commitment = asset_type.value_commitment(value, rcv)
    expsk = ExpandedSpendingKey.from_spending_key(b"\x42" * 32)
    pgk = expsk.proof_generation_key()
    vk = pgk.to_viewing_key()
    d = 0
    while True:
        div = Diversifier(d.to_bytes(11, "little"))
        addr = vk.to_payment_address(div)
        if addr is not None:
            break
        d += 1
    rcm = random_jubjub_fr(rng)
    ar = random_jubjub_fr(rng)
    auth_path = [
        (Scalar.from_bytes_wide(rng.fill_bytes(64)).n, rng.next_u32() % 2 != 0)
        for _ in range(32)
    ]
    note = Note(asset_type=asset_type, value=value, g_d=addr.g_d(),
                pk_d=addr.pk_d, rseed=Rseed.before_zip212(rcm))
    cur = note.cmu().n
    position = 0
    for i, (sibling, is_right) in enumerate(auth_path):
        if is_right:
            position |= 1 << i
            lhs, rhs = sibling, cur
        else:
            lhs, rhs = cur, sibling
        cur = int.from_bytes(
            merkle_hash(i, lhs.to_bytes(32, "little"), rhs.to_bytes(32, "little")),
            "little",
        )
    anchor = cur
    nf = note.nf(vk.nk, position)
    rk = vk.rk(ar)

    def make():
        return Spend(
            value_commitment=value_commitment,
            proof_generation_key=pgk,
            payment_address=addr,
            commitment_randomness=rcm,
            ar=ar,
            auth_path=list(auth_path),
            anchor=anchor,
        )

    inputs = spend_public_inputs(rk, value_commitment.commitment(), anchor, nf)
    return make, inputs


def _convert_fixture(rng):
    """Mirrors masp_proofs/benches/convert.rs: an AllowedConversion leaf
    (pedersen hash of the asset generator bits) in a 32-deep tree."""
    from masp_tpu_torch.host.circuits.convert import Convert
    from masp_tpu_torch.host.fields import Scalar
    from masp_tpu_torch.groth16.public_inputs import convert_public_inputs
    from masp_tpu_torch.host.primitives.asset_type import AssetType
    from masp_tpu_torch.host.primitives.pedersen import Personalization, pedersen_hash
    from masp_tpu_torch.host.primitives.sapling import merkle_hash
    from masp_tpu_torch.host.rng import random_jubjub_fr

    asset_type = AssetType.new(b"convert-bench")
    value_commitment = asset_type.value_commitment(1234567, random_jubjub_fr(rng))
    gen_bytes = asset_type.asset_generator().to_bytes()
    leaf_bits = [(b >> i) & 1 == 1 for b in gen_bytes for i in range(8)]
    cur = pedersen_hash(Personalization.note_commitment(), leaf_bits).to_affine()[0].n
    auth_path = [
        (Scalar.from_bytes_wide(rng.fill_bytes(64)).n, rng.next_u32() % 2 != 0)
        for _ in range(32)
    ]
    for i, (sibling, is_right) in enumerate(auth_path):
        lhs, rhs = (sibling, cur) if is_right else (cur, sibling)
        cur = int.from_bytes(
            merkle_hash(i, lhs.to_bytes(32, "little"), rhs.to_bytes(32, "little")),
            "little",
        )
    anchor = cur

    def make():
        return Convert(
            value_commitment=value_commitment,
            auth_path=list(auth_path),
            anchor=anchor,
        )

    inputs = convert_public_inputs(value_commitment.commitment(), anchor)
    return make, inputs


def _output_fixture(rng):
    from masp_tpu_torch.host.circuits.sapling import Output
    from masp_tpu_torch.groth16.public_inputs import output_public_inputs
    from masp_tpu_torch.host.primitives.asset_type import AssetType
    from masp_tpu_torch.host.primitives.keys import ExpandedSpendingKey
    from masp_tpu_torch.host.primitives.sapling import Diversifier, Note, Rseed
    from masp_tpu_torch.host.rng import random_jubjub_fr

    asset_type = AssetType.new(b"default")
    vc = asset_type.value_commitment(12345, random_jubjub_fr(rng))
    expsk = ExpandedSpendingKey.from_spending_key(b"\x44" * 32)
    vk = expsk.proof_generation_key().to_viewing_key()
    d = 0
    while True:
        div = Diversifier(d.to_bytes(11, "little"))
        addr = vk.to_payment_address(div)
        if addr is not None:
            break
        d += 1
    esk = random_jubjub_fr(rng)
    rcm = random_jubjub_fr(rng)

    def make():
        return Output(
            value_commitment=vc,
            asset_identifier=list(asset_type.identifier_bits()),
            payment_address=addr,
            commitment_randomness=rcm,
            esk=esk,
        )

    note = addr.create_note(asset_type, 12345, Rseed.before_zip212(rcm))
    inputs = output_public_inputs(vc.commitment(), addr.g_d() * esk, note.cmu().n)
    return make, inputs


def fixture(kind: str):
    """(make_circuit, public_inputs) of circuit ``kind`` ("spend", "output"
    or "convert") from an XorShiftRng seeded as bench.py seeds it."""
    make = {"spend": _spend_fixture, "output": _output_fixture, "convert": _convert_fixture}[kind]
    return make(XorShiftRng.from_seed(BENCH_SEED))


__all__ = ["fixture", "BENCH_SEED"]
