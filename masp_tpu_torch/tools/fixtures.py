# Copies of _spend_fixture, _convert_fixture and _output_fixture from bench.py,
# verbatim apart from import paths; the port imports nothing of masp_tpu.
"""Seeded instances of the Spend, Output and Convert circuits, as bench.py
builds them: each fixture returns (make_circuit, public_inputs), where
make_circuit() gives a fresh circuit instance with its full witness.
``fixture(kind)`` seeds an XorShiftRng with bench.py's seed, so its instance
equals the one bench.py proves. ``jobs`` gives a seeded bundle of Spend,
Convert and Output jobs, as ``SaplingProvingContext.prove_jobs`` takes them."""

from __future__ import annotations

from masp_tpu_torch.host.rng import XorShiftRng

BENCH_SEED = bytes(range(16))


def _spend_fixture(rng):
    from masp_tpu_torch.host.circuits.sapling import Spend
    from masp_tpu_torch.host.fields import Scalar
    from masp_tpu_torch.groth16.sapling_prover import spend_public_inputs
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
    from masp_tpu_torch.groth16.sapling_prover import convert_public_inputs
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
    from masp_tpu_torch.groth16.sapling_prover import output_public_inputs
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


def _auth_path(rng, leaf):
    """A 32-level MerklePath to ``leaf`` (a Node) with random siblings and
    sides, drawn as _spend_fixture draws them, and its root as an int."""
    from masp_tpu_torch.host.fields import Scalar
    from masp_tpu_torch.host.primitives.merkle_tree import MerklePath
    from masp_tpu_torch.host.primitives.sapling import Node

    steps = [(Scalar.from_bytes_wide(rng.fill_bytes(64)), rng.next_u32() % 2 != 0) for _ in range(32)]
    path = MerklePath([(Node.from_scalar(sib), right) for sib, right in steps],
                      sum(1 << i for i, (_, right) in enumerate(steps) if right))
    return path, int.from_bytes(path.root(leaf).repr, "little")


def jobs(n_spend: int, n_convert: int, n_output: int, seed: bytes = BENCH_SEED) -> dict:
    """A seeded bundle: {"spend", "convert", "output"}: the job dicts that
    ``SaplingProvingContext.prove_jobs`` takes; "value_balance": the
    bundle's ValueSum (spent plus converted minus output), for
    ``binding_sig``; "verifier": per kind what a verifier reads from each
    description besides cv, rk and the proof (spend: anchor and nullifier;
    convert: anchor; output: cmu and epk); "ask": each spend's spend
    authorising key. Spends and outputs move two assets; each convert turns
    one unit of the first into two of the second through an
    AllowedConversion whose leaf sits in a random 32-level tree, as each
    spent note's does."""
    from masp_tpu_torch.host.primitives.asset_type import AssetType
    from masp_tpu_torch.host.primitives.convert import AllowedConversion
    from masp_tpu_torch.host.primitives.keys import ExpandedSpendingKey
    from masp_tpu_torch.host.primitives.redjubjub import PrivateKey
    from masp_tpu_torch.host.primitives.sapling import Diversifier, Note, Rseed
    from masp_tpu_torch.host.rng import random_jubjub_fr
    from masp_tpu_torch.host.transaction.amount import ValueSum

    rng = XorShiftRng.from_seed(seed)
    assets = [AssetType.new(b"default"), AssetType.new(b"convert-bench")]
    expsk = ExpandedSpendingKey.from_spending_key(b"\x42" * 32)
    pgk = expsk.proof_generation_key()
    vk = pgk.to_viewing_key()
    d = 0
    while (addr := vk.to_payment_address(div := Diversifier(d.to_bytes(11, "little")))) is None:
        d += 1
    out = {"spend": [], "convert": [], "output": [], "value_balance": ValueSum.zero(),
           "verifier": {"spend": [], "convert": [], "output": []}, "ask": []}
    for i in range(n_spend):
        asset, value = assets[i % 2], 1000 * (i + 1)
        rseed = Rseed.before_zip212(random_jubjub_fr(rng))
        note = Note(asset_type=asset, value=value, g_d=addr.g_d(), pk_d=addr.pk_d, rseed=rseed)
        path, anchor = _auth_path(rng, note.commitment())
        out["spend"].append({
            "proof_generation_key": pgk, "diversifier": div, "rseed": rseed,
            "ar": random_jubjub_fr(rng), "asset_type": asset, "value": value,
            "anchor": anchor, "merkle_path": path, "rcv": random_jubjub_fr(rng)})
        out["verifier"]["spend"].append((anchor, note.nf(vk.nk, path.position)))
        out["ask"].append(PrivateKey(expsk.ask))
        out["value_balance"] = out["value_balance"] + ValueSum.from_pair(asset, value)
    conversion = AllowedConversion.from_assets(
        ValueSum.from_pair(assets[0], -1) + ValueSum.from_pair(assets[1], 2))
    for i in range(n_convert):
        value = 7 * (i + 1)
        path, anchor = _auth_path(rng, conversion.commitment())
        out["convert"].append({"allowed_conversion": conversion, "value": value, "anchor": anchor,
                               "merkle_path": path, "rcv": random_jubjub_fr(rng)})
        out["verifier"]["convert"].append(anchor)
        out["value_balance"] = out["value_balance"] + conversion.assets * value
    for i in range(n_output):
        asset, value = assets[i % 2], 300 * (i + 1)
        esk, rcm = random_jubjub_fr(rng), random_jubjub_fr(rng)
        out["output"].append({"esk": esk, "payment_address": addr, "rcm": rcm, "asset_type": asset,
                              "value": value, "rcv": random_jubjub_fr(rng)})
        note = addr.create_note(asset, value, Rseed.before_zip212(rcm))
        out["verifier"]["output"].append((note.cmu().n, addr.g_d() * esk))
        out["value_balance"] = out["value_balance"] - ValueSum.from_pair(asset, value)
    return out


__all__ = ["fixture", "jobs", "BENCH_SEED"]
