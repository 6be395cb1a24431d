"""The port's transaction builder, ZIP-32 keys and note encryption against
the JAX package's, on the CPU: host/crypto.py against RFC 8439 and FIPS-197
and byte for byte against the `cryptography` package; the seeded builds of
the JAX package's builder tests through both packages' MockTxProver (equal
bytes, txids and stored build parameters); the wallet flow of
masp_tpu_torch/tools/wallet.py through LocalTxProver with the proving
stubbed as tests/test_torch_batch.py stubs it, whose transaction passes
the port's BatchValidator; the ZIP-32 and note-encryption vectors through
the port's copies; and a compact scan at 64 outputs through the device
branch of batch_epk (its twin on the CPU tensor route) against the JAX
package's host route. chip_smoke.py --tx drives the same wallet flow on the
card with the real circuits."""

import importlib
import json
import pathlib
import random
from types import SimpleNamespace

import pytest

from masp_tpu.fields import JubjubFr as JJubjubFr
from masp_tpu.note_encryption import batch_try_compact_note_decryption as jbatch_try_compact
from masp_tpu.primitives.consensus import TEST_NETWORK as JTEST_NETWORK
from masp_tpu.note_encryption.sapling_domain import SaplingDomain as JSaplingDomain
from masp_tpu.primitives.sapling import SaplingIvk as JSaplingIvk
from masp_tpu_torch.groth16 import prover as TP
from masp_tpu_torch.groth16 import sapling_prover as SP
from masp_tpu_torch.groth16.local_prover import LocalTxProver
from masp_tpu_torch.host import crypto as C
from masp_tpu_torch.host import structures as HS
from masp_tpu_torch.host.bls12_381 import G1, G2
from masp_tpu_torch.host.rng import XorShiftRng, random_scalar
from masp_tpu_torch.ops import jubjub as TJ
from masp_tpu_torch.ops import pedersen as TPED
from masp_tpu_torch.tools import wallet as W
from tests.test_torch_batch import _stub_proving
from tests.test_torch_prover import _one_torch_thread  # noqa: F401 (autouse fixture)

DATA = pathlib.Path(__file__).parent / "data"
SUNSCREEN = (b"Ladies and Gentlemen of the class of '99: If I could offer you only one tip for the future, "
             b"sunscreen would be it.")


def test_crypto_matches_rfc8439_and_fips197():
    """RFC 8439 §2.4.2 (ChaCha20 from block 1), §2.5.2 (Poly1305), §2.8.2
    (the AEAD, and a wrong tag raising InvalidTag) and FIPS-197 appendix
    C.3 (AES-256)."""
    nonce = bytes.fromhex("000000000000004a00000000")
    stream = C.Cipher(C.algorithms.ChaCha20(bytes(range(32)), (1).to_bytes(4, "little") + nonce), mode=None)
    assert stream.encryptor().update(SUNSCREEN).hex() == (
        "6e2e359a2568f98041ba0728dd0d6981e97e7aec1d4360c20a27afccfd9fae0bf91b65c5524733ab8f593dabcd62b357"
        "1639d624e65152ab8f530c359f0861d807ca0dbf500d6a6156a38e088a22b65e52bc514d16ccf806818ce91ab7793736"
        "5af90bbf74a35be6b40b8eedf2785e42874d")
    key = bytes.fromhex("85d6be7857556d337f4452fe42d506a80103808afb0db2fd4abff6af4149f51b")
    assert C._poly1305(key, b"Cryptographic Forum Research Group").hex() == "a8061dc1305136c6c22b8baf0c0127a9"
    aead = C.ChaCha20Poly1305(bytes(range(0x80, 0xA0)))
    nonce, aad = bytes.fromhex("070000004041424344454647"), bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
    sealed = aead.encrypt(nonce, SUNSCREEN, aad)
    assert sealed.hex() == (
        "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d63dbea45e8ca9671282fafb69da92728b"
        "1a71de0a9e060b2905d6a5b67ecd3b3692ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
        "3ff4def08e4b7a9de576d26586cec64b6116" "1ae10b594f09e26a7e902ecbd0600691")
    assert aead.decrypt(nonce, sealed, aad) == SUNSCREEN
    for bad in (sealed[:-1] + bytes([sealed[-1] ^ 1]), bytes([sealed[0] ^ 0x80]) + sealed[1:], sealed[:15]):
        with pytest.raises(C.InvalidTag):
            aead.decrypt(nonce, bad, aad)
    with pytest.raises(C.InvalidTag):
        aead.decrypt(nonce, sealed, aad + b"\x00")
    enc = C.Cipher(C.algorithms.AES(bytes(range(32))), C.modes.ECB()).encryptor()
    block = enc.update(bytes.fromhex("00112233445566778899aabbccddeeff")) + enc.finalize()
    assert block.hex() == "8ea2b7ca516745bfeafc49904b496089"


def test_crypto_matches_cryptography():
    """Seeded keys, nonces and lengths 0-1,200 bytes (52 and 580 among
    them; the note plaintexts are 84 and 596 bytes): the AEAD, ChaCha20 from
    a seeded counter (also across the 32-bit counter's wrap, and fed in two
    updates), AES-ECB, all equal to `cryptography`'s bytes; a wrong tag
    raises InvalidTag in both."""
    pytest.importorskip("cryptography")
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305

    rng = random.Random(17)
    lengths = [0, 1, 15, 16, 17, 52, 63, 64, 65, 84, 580, 596, 612, 1200] + [rng.randrange(1201) for _ in range(10)]
    for n in lengths:
        key, nonce, data = rng.randbytes(32), rng.randbytes(12), rng.randbytes(n)
        aad = rng.randbytes(rng.choice((0, 1, 16, 33)))
        sealed = C.ChaCha20Poly1305(key).encrypt(nonce, data, aad)
        assert sealed == ChaCha20Poly1305(key).encrypt(nonce, data, aad), n
        assert C.ChaCha20Poly1305(key).decrypt(nonce, sealed, aad) == data
        bad = bytearray(sealed)
        bad[rng.randrange(len(bad))] ^= 1 << rng.randrange(8)
        with pytest.raises(C.InvalidTag):
            C.ChaCha20Poly1305(key).decrypt(nonce, bytes(bad), aad)
        with pytest.raises(InvalidTag):
            ChaCha20Poly1305(key).decrypt(nonce, bytes(bad), aad)
        for counter in (0, 1, rng.randrange(1 << 32), (1 << 32) - 2):
            n16 = counter.to_bytes(4, "little") + nonce
            want = Cipher(algorithms.ChaCha20(key, n16), mode=None).decryptor().update(data)
            assert C.Cipher(C.algorithms.ChaCha20(key, n16), mode=None).decryptor().update(data) == want, (n, counter)
            ctx, cut = C.Cipher(C.algorithms.ChaCha20(key, n16), mode=None).encryptor(), rng.randrange(n + 1)
            assert ctx.update(data[:cut]) + ctx.update(data[cut:]) == want, (n, counter, cut)
        blocks, aes_key = rng.randbytes(n - n % 16), rng.randbytes(32)
        enc = Cipher(algorithms.AES(aes_key), modes.ECB()).encryptor()
        want = enc.update(blocks) + enc.finalize()
        enc = C.Cipher(C.algorithms.AES(aes_key), C.modes.ECB()).encryptor()
        assert enc.update(blocks) + enc.finalize() == want, n


# --- the builds of tests/test_transaction.py and tests/test_convert_builder.py ------

def _package(root: str, rng_module: str) -> SimpleNamespace:
    """The builder's names in one package: masp_tpu or the port's copies."""
    m = {k: importlib.import_module(f"{root}.{k}") for k in (
        "primitives.asset_type", "primitives.consensus", "primitives.convert", "primitives.memo",
        "primitives.merkle_tree", "primitives.sapling", "primitives.zip32", "transaction.amount",
        "transaction.builder", "transaction.components.sapling_builder", "transaction.components.transparent",
        "transaction.fees", "transaction.transaction", "transaction.tx_prover")}
    names = {}
    for mod in m.values():
        names.update({k: getattr(mod, k) for k in getattr(mod, "__all__", dir(mod)) if not k.startswith("_")})
    names.update({k: getattr(m[f"primitives.{mod}"], k) for mod, k in (
        ("consensus", "TEST_NETWORK"), ("merkle_tree", "CommitmentTree"), ("merkle_tree", "IncrementalWitness"))})
    names["XorShiftRng"] = importlib.import_module(rng_module).XorShiftRng
    return SimpleNamespace(**names)


PACKAGES = {"jax": ("masp_tpu", "masp_tpu.utils.rng"), "port": ("masp_tpu_torch.host", "masp_tpu_torch.host.rng")}


def _spend_of(p, rng, seed, asset, value, builder):
    xsk = p.ExtendedSpendingKey.master(seed)
    addr = xsk.default_address()[1]
    note = addr.create_note(asset, value, p.Rseed.after_zip212(rng.fill_bytes(32)))
    tree = p.CommitmentTree.empty()
    tree.append(note.commitment())
    builder.add_sapling_spend(p.PseudoExtendedKey.from_spending_key(xsk), addr.diversifier, note,
                              p.IncrementalWitness.from_tree(tree).path())
    return xsk, addr


def _builds(p) -> dict:
    """Each build's transaction bytes, txid and stored build parameters."""
    out = {}
    asset = p.AssetType.new(b"test-asset")
    prover = p.MockTxProver(real_binding_sig=True)

    def record(name, tx, stored):
        out[name] = (tx.to_bytes(), tx.txid().data, stored.to_bytes() if stored is not None else None)
        assert p.Transaction.from_bytes(out[name][0]).to_bytes() == out[name][0]

    rng = p.XorShiftRng.from_seed(bytes(range(16)))
    b = p.Builder(p.TEST_NETWORK, 10)
    xsk, addr = _spend_of(p, rng, b"builder test seed", asset, 100_000, b)
    b.add_sapling_output(xsk.expsk.ovk, addr, asset, 99_000, p.MemoBytes.empty())
    bparams = p.RngBuildParams(rng)
    record("full", b.build(prover, p.FixedFeeRule.non_standard(p.ValueSum.from_pair(asset, 1000, p.U64)), rng,
                           bparams)[0], bparams.to_stored())

    txs = []
    bparams = p.RngBuildParams(p.XorShiftRng.from_seed(b"B" * 16))
    for replay in (False, True):
        b = p.Builder(p.TEST_NETWORK, 10)
        _xsk, addr = _spend_of(p, p.XorShiftRng.from_seed(bytes(range(32, 48))), b"builder test seed", asset,
                               100_000, b)
        b.add_sapling_output(None, addr, asset, 100_000, p.MemoBytes.empty())
        params = p.StoredBuildParams.from_bytes(bparams.to_stored().to_bytes()) if replay else bparams
        txs.append(b.build(prover, p.FixedFeeRule.non_standard(p.ValueSum.zero(p.U64)),
                           p.XorShiftRng.from_seed(b"R" * 16), params)[0])
    assert txs[0].to_bytes() == txs[1].to_bytes() and txs[0].txid() == txs[1].txid()
    record("stored", txs[1], bparams.to_stored())

    rng = p.XorShiftRng.from_seed(bytes(range(16)))
    asset_a, asset_b = p.AssetType.new(b"asset-A"), p.AssetType.new(b"asset-B")
    b = p.Builder(p.TEST_NETWORK, 10)
    xsk, addr = _spend_of(p, rng, b"convert wallet seed", asset_a, 10_000, b)
    allowed = p.AllowedConversion.from_assets(
        p.ValueSum.from_pair(asset_a, -1, p.I128) + p.ValueSum.from_pair(asset_b, 2, p.I128))
    ctree = p.CommitmentTree.empty()
    ctree.append(allowed.commitment())
    b.add_sapling_convert(allowed, 2_000, p.IncrementalWitness.from_tree(ctree).path())
    b.add_sapling_output(xsk.expsk.ovk, addr, asset_a, 7_000, p.MemoBytes.empty())
    b.add_sapling_output(xsk.expsk.ovk, addr, asset_b, 4_000, p.MemoBytes.empty())
    bparams = p.RngBuildParams(rng)
    record("convert", b.build(prover, p.FixedFeeRule.non_standard(p.ValueSum.from_pair(asset_a, 1_000, p.U64)),
                              rng, bparams)[0], bparams.to_stored())

    rng = p.XorShiftRng.from_seed(bytes(range(48, 64)))
    b = p.Builder(p.TEST_NETWORK, 10)
    addr20 = p.TransparentAddress(b"\x01" * 20)
    b.add_transparent_input(p.TxOut(asset, 500, addr20))
    b.add_transparent_output(addr20, asset, 400)
    tx, _ = b.build(prover, p.FixedFeeRule.non_standard(p.ValueSum.from_pair(asset, 100, p.U64)), rng,
                    p.RngBuildParams(rng))
    assert tx.sapling_bundle is None
    record("transparent", tx, None)

    b = p.Builder(p.TEST_NETWORK, 10)
    _spend_of(p, p.XorShiftRng.from_seed(bytes(range(16, 32))), b"builder test seed", asset, 100, b)
    b.add_sapling_output(None, addr, asset, 200, p.MemoBytes.empty())
    with pytest.raises(p.InsufficientFunds):
        b.build(prover, p.FixedFeeRule.non_standard(p.ValueSum.zero(p.U64)), rng, p.RngBuildParams(rng))
    return out


def test_builds_match_jax():
    """The builds of the JAX package's builder tests (a spend with change
    and fee; a rebuild from stored build parameters through their borsh
    bytes; a spend, a convert and two outputs; transparent only; and
    insufficient funds) through both packages' MockTxProver: equal
    transaction bytes, txids and stored build parameters."""
    jax, port = (_builds(_package(*PACKAGES[k])) for k in ("jax", "port"))
    assert list(port) == ["full", "stored", "convert", "transparent"]
    for name in port:
        assert port[name] == jax[name], name


# --- the wallet flow through LocalTxProver ----------------------------------------

def _on_cpu(monkeypatch):
    """The device twins behind the copied device branches, on the CPU
    tensor route; returns the widths each was called at."""
    calls = {"merkle": [], "epk": []}
    merkle, epk = TPED.batch_merkle_hash, TJ.batch_from_bytes

    def merkle_on_cpu(depth, pairs):
        calls["merkle"].append(len(pairs))
        return merkle(depth, pairs, device="cpu")

    def epk_on_cpu(items, zip_216_enabled=True):
        calls["epk"].append(len(items))
        return epk(items, zip_216_enabled, device="cpu")

    monkeypatch.setattr(TPED, "batch_merkle_hash", merkle_on_cpu)
    monkeypatch.setattr(TJ, "batch_from_bytes", epk_on_cpu)
    return calls


def test_local_prover_transaction_validates(monkeypatch):
    """wallet.py's flow at 128 leaves and 128 conversions: both trees
    through FrozenCommitmentTree's device branch (one level of 64 pairs on
    the CPU route) equal to the host's root and IncrementalWitness paths;
    the transaction of 2 Spends, 1 Convert, 3 Outputs and a transparent
    output through LocalTxProver.prove_jobs with the proving stubbed; it
    re-parses to the same bytes and txid, passes BatchValidator (and fails it
    with one binding signature byte flipped); every output decrypts to what
    was sent and the sender's ovk recovers all but the one without it; the
    rebuild from the stored build parameters differs only in the proofs."""
    from masp_tpu_torch.host.note_encryption import try_note_decryption, try_output_recovery_with_ovk
    from masp_tpu_torch.host.note_encryption.sapling_domain import SaplingDomain
    from masp_tpu_torch.host.primitives.merkle_tree import FrozenCommitmentTree
    from masp_tpu_torch.host.primitives.redjubjub import Signature
    from masp_tpu_torch.host.primitives.consensus import TEST_NETWORK
    from masp_tpu_torch.host.transaction.components.sapling_builder import RngBuildParams, StoredBuildParams
    from masp_tpu_torch.host.transaction.fees import FixedFeeRule
    from masp_tpu_torch.host.transaction.sighash import SignableInput, signature_hash
    from masp_tpu_torch.host.transaction.transaction import Transaction
    from masp_tpu_torch.host.transaction.txid import TxIdDigester

    calls = _on_cpu(monkeypatch)
    monkeypatch.delenv("MASP_MERKLE_DEVICE_MIN", raising=False)
    _stub_proving(monkeypatch, TP, SP, HS.Proof, G1.generator(), G2.generator(), random_scalar)
    w = W.make_wallet(W.SEED, 128, 128)
    tree, ctree = FrozenCommitmentTree.new(w.leaves), FrozenCommitmentTree.new(w.conversions)
    assert calls["merkle"] == [64, 64]
    root, paths = W.host_paths(w.leaves, w.positions)
    croot, (cpath,) = W.host_paths(w.conversions, (w.conversion_pos,))
    assert (tree.root(), ctree.root()) == (root, croot)
    spend_paths = [tree.path(p) for p in w.positions]
    assert [p.to_bytes() for p in spend_paths] == [p.to_bytes() for p in paths]
    assert ctree.path(w.conversion_pos).to_bytes() == cpath.to_bytes()

    vk = object()
    prover = LocalTxProver.__new__(LocalTxProver)
    prover.spend_params = prover.output_params = prover.convert_params = None
    prover.spend_vk = prover.output_vk = prover.convert_vk = vk
    bparams = RngBuildParams(XorShiftRng.from_seed(b"P" * 16))
    tx, meta = W.builder(w, spend_paths, ctree.path(w.conversion_pos)).build(
        prover, FixedFeeRule.non_standard(W.fee()), XorShiftRng.from_seed(b"R" * 16), bparams)
    bundle = tx.sapling_bundle
    assert [len(x) for x in (bundle.shielded_spends, bundle.shielded_converts, bundle.shielded_outputs)] == [2, 1, 3]
    assert len(tx.transparent_bundle.vout) == 1
    raw = tx.to_bytes()
    again = Transaction.from_bytes(raw)
    assert again.to_bytes() == raw and again.txid() == tx.txid()

    sighash = signature_hash(tx.data, SignableInput.shielded(), tx.data.digest(TxIdDigester()))
    sig = bundle.authorization.binding_sig
    flipped = bytearray(sig.sbar)
    flipped[0] ^= 1
    for binding_sig, want in ((sig, True), (Signature(sig.rbar, bytes(flipped)), False)):
        validator = SP.BatchValidator()
        assert validator.check_bundle(SimpleNamespace(
            shielded_spends=bundle.shielded_spends, shielded_converts=bundle.shielded_converts,
            shielded_outputs=bundle.shielded_outputs, value_balance=bundle.value_balance,
            authorization=SimpleNamespace(binding_sig=binding_sig)), sighash)
        assert validator.validate(vk, vk, vk, XorShiftRng.from_seed(b"V" * 16)) is want

    domain = SaplingDomain(TEST_NETWORK, W.HEIGHT)
    ivk = {id(w.addr): w.ivks()[0], id(w.child_addr): w.ivks()[1]}
    for n, (ovk, to, asset, value, memo) in enumerate(W.outputs(w)):
        out = bundle.shielded_outputs[meta.output_index(n)]
        note, got_to, got_memo = try_note_decryption(domain, ivk[id(to)], out)
        assert (note.asset_type, note.value, got_to, got_memo) == (asset, value, to, memo)
        recovered = try_output_recovery_with_ovk(domain, w.xsk.expsk.ovk, out, out.cv, out.out_ciphertext)
        assert (recovered is not None) == (ovk is not None)
        if recovered is not None:
            assert recovered[0] == note and recovered[1:] == (to, memo)

    stored = StoredBuildParams.from_bytes(bparams.to_stored().to_bytes())
    rebuilt, _ = W.builder(w, spend_paths, ctree.path(w.conversion_pos)).build(
        prover, FixedFeeRule.non_standard(W.fee()), XorShiftRng.from_seed(b"R" * 16), stored)
    assert rebuilt.txid() == tx.txid()
    assert W.without_proofs(rebuilt) == W.without_proofs(tx)


# --- vectors and the compact scan ---------------------------------------------------

def test_vectors_and_compact_scan_match_jax(monkeypatch):
    """The ZIP-32 vectors (tests/test_zip32_vectors.py's fields) and the
    note-encryption vectors (tests/test_note_encryption.py's flow) through
    the port's copies; then 64 compact outputs of wallet.py's notes through
    batch_try_compact_note_decryption with two ivks: the port's device
    branch of batch_epk (ops/jubjub.batch_from_bytes on the CPU tensor
    route) gives the JAX package's host-route results, output by output."""
    from masp_tpu_torch.host.fields import JubjubFr, Scalar
    from masp_tpu_torch.host.jubjub import ExtendedPoint
    from masp_tpu_torch.host.note_encryption import (
        NoteEncryption, batch_try_compact_note_decryption, try_compact_note_decryption, try_note_decryption,
        try_output_recovery_with_ovk,
    )
    from masp_tpu_torch.host.note_encryption.sapling_domain import SaplingDomain, kdf_sapling, sapling_ka_agree
    from masp_tpu_torch.host.primitives.asset_type import AssetType
    from masp_tpu_torch.host.primitives.consensus import TEST_NETWORK
    from masp_tpu_torch.host.primitives.keys import OutgoingViewingKey
    from masp_tpu_torch.host.primitives.memo import MemoBytes
    from masp_tpu_torch.host.primitives.sapling import Diversifier, PaymentAddress, Rseed, SaplingIvk
    from masp_tpu_torch.host.primitives.zip32 import (
        ChildIndex, DiversifierIndex, ExtendedSpendingKey, fvk_fingerprint, sapling_derive_internal_fvk,
    )

    m = ExtendedSpendingKey.master(bytes(range(32)))
    m_1 = m.derive_child(ChildIndex.non_hardened(1))
    m_1_2h = m_1.derive_child(ChildIndex.hardened(2))
    m_1_2hv = m_1_2h.to_extended_full_viewing_key()
    xfvks = [m.to_extended_full_viewing_key(), m_1.to_extended_full_viewing_key(), m_1_2hv, m_1_2hv,
             m_1_2hv.derive_child(ChildIndex.non_hardened(3))]
    vectors = json.loads((DATA / "zip32_vectors.json").read_text())
    assert len(vectors) == 5
    for xsk, tv in zip([m, m_1, m_1_2h], vectors):
        internal = xsk.derive_internal()
        assert (xsk.expsk.ask.to_bytes().hex(), xsk.expsk.nsk.to_bytes().hex(), xsk.expsk.ovk.data.hex(),
                xsk.dk.data.hex(), xsk.chain_code.hex(), xsk.to_bytes().hex()) == tuple(
            tv[k] for k in ("ask", "nsk", "ovk", "dk", "c", "xsk"))
        assert (internal.expsk.nsk.to_bytes().hex(), internal.expsk.ovk.data.hex(), internal.dk.data.hex(),
                internal.to_bytes().hex()) == tuple(
            tv[k] for k in ("internal_nsk", "internal_ovk", "internal_dk", "internal_xsk"))
    for xfvk, tv in zip(xfvks, vectors):
        assert (xfvk.fvk.vk.ak.to_bytes().hex(), xfvk.fvk.vk.nk.point.to_bytes().hex(), xfvk.fvk.ovk.data.hex(),
                xfvk.dk.data.hex(), xfvk.chain_code.hex(), xfvk.fvk.vk.ivk().fr.to_bytes().hex(),
                xfvk.to_bytes().hex(), fvk_fingerprint(xfvk.fvk).hex()) == tuple(
            tv[k] for k in ("ak", "nk", "ovk", "dk", "c", "ivk", "xfvk", "fp"))
        ifvk, idk = sapling_derive_internal_fvk(xfvk.fvk, xfvk.dk)
        assert (ifvk.vk.nk.point.to_bytes().hex(), ifvk.ovk.data.hex(), idk.data.hex(),
                ifvk.vk.ivk().fr.to_bytes().hex(), fvk_fingerprint(ifvk).hex()) == tuple(
            tv[k] for k in ("internal_nk", "internal_ovk", "internal_dk", "internal_ivk", "internal_fp"))
        for key, j in (("d0", 0), ("d1", 1), ("d2", 2), ("dmax", None)):
            d = xfvk.dk.diversifier(DiversifierIndex(b"\xff" * 11) if j is None else DiversifierIndex.from_u64(j))
            assert (None if d is None else d.d.hex()) == tv[key], key
    assert xfvks[0].dk.diversifier_index(Diversifier(bytes.fromhex(vectors[0]["d0"]))) == DiversifierIndex.from_u64(0)

    asset = AssetType.from_identifier(b"testtesttesttesttesttesttesttest")
    domain = SaplingDomain(TEST_NETWORK, 0)
    for i, tv in enumerate(json.loads((DATA / "note_encryption_vectors.json").read_text())):
        b = lambda k: bytes.fromhex(tv[k])  # noqa: E731
        ivk, esk = SaplingIvk(JubjubFr.from_bytes(b("ivk"))), JubjubFr.from_bytes(b("esk"))
        pk_d, cv = ExtendedPoint.from_bytes(b("default_pk_d")), ExtendedPoint.from_bytes(b("cv"))
        to = PaymentAddress.from_parts(Diversifier(b("default_d")), pk_d)
        note = to.create_note(asset, tv["v"], Rseed.before_zip212(JubjubFr.from_bytes(b("rcm"))))
        assert kdf_sapling(sapling_ka_agree(esk, pk_d), b("epk")) == b("k_enc")
        assert note.cmu().to_bytes() == b("cmu")
        ne = NoteEncryption.new_with_esk(domain, esk, OutgoingViewingKey(b("ovk")), note, to, MemoBytes(b("memo")))
        assert domain.epk_bytes(ne.epk) == b("epk") and ne.encrypt_note_plaintext() == b("c_enc")
        assert ne.encrypt_outgoing_plaintext(cv, Scalar.from_bytes(b("cmu")), XorShiftRng.from_seed(bytes(16))) == b(
            "c_out")
        output = SimpleNamespace(ephemeral_key=b("epk"), cmstar_bytes=b("cmu"), enc_ciphertext=b("c_enc"))
        assert try_note_decryption(domain, ivk, output)[:2] == (note, to), i
        compact = SimpleNamespace(ephemeral_key=b("epk"), cmstar_bytes=b("cmu"), enc_ciphertext=b("c_enc")[:84])
        assert try_compact_note_decryption(domain, ivk, compact)[0] == note, i
        assert try_output_recovery_with_ovk(domain, OutgoingViewingKey(b("ovk")), output, cv, b("c_out"))[0] == note
        assert try_note_decryption(domain, SaplingIvk(JubjubFr(12345)), output) is None

    calls = _on_cpu(monkeypatch)
    monkeypatch.delenv("MASP_EPK_DEVICE_MIN", raising=False)
    w = W.make_wallet(W.SEED, 64, 0)
    outs = W.compact_outputs(w, range(64))
    got = [W.scan_key(r) for r in batch_try_compact_note_decryption(w.ivks(), outs)]
    assert calls["epk"] == [64]
    assert [None if g is None else g[-1] for g in got] == W.expected_scan(w, range(64))
    jdomain = JSaplingDomain(JTEST_NETWORK, W.HEIGHT)
    jivks = [JSaplingIvk(JJubjubFr.from_bytes(ivk.fr.to_bytes())) for ivk in w.ivks()]
    monkeypatch.setenv("MASP_EPK_DEVICE_MIN", "0")
    want = [None if r is None else (r[0][0].asset_type.get_identifier(), r[0][0].value, r[0][0].rcm().to_bytes(),
                                    r[0][1].to_bytes(), r[1])
            for r in jbatch_try_compact(jivks, [(jdomain, o) for _, o in outs])]
    assert got == want
