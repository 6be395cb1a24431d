"""A seeded wallet over the port's transaction builder, as a user of one card
runs it: ZIP-32 keys and addresses, funding notes at known positions of a
note-commitment tree, a conversion tree, a MASP transaction of 2 Spends of two
asset types, 1 Convert, 3 Outputs and one transparent output built through
a TxProver, and the compact outputs a wallet trial-decrypts when it catches
up with the chain.

chip_smoke.py's phase tx drives it on the card with LocalTxProver and the
real circuits; tests/test_torch_transaction.py drives it on the CPU with the
proving stubbed. The trees are built by the caller (FrozenCommitmentTree.new
takes its device route at 64 pairs a level and up); ``host_paths`` gives the
host's root and paths to hold them against."""

from __future__ import annotations

from dataclasses import dataclass, replace
from types import SimpleNamespace

from masp_tpu_torch.host.note_encryption import COMPACT_NOTE_SIZE, NoteEncryption
from masp_tpu_torch.host.note_encryption.sapling_domain import SaplingDomain
from masp_tpu_torch.host.primitives.asset_type import AssetType
from masp_tpu_torch.host.primitives.consensus import TEST_NETWORK
from masp_tpu_torch.host.primitives.convert import AllowedConversion
from masp_tpu_torch.host.primitives.memo import MemoBytes
from masp_tpu_torch.host.primitives.merkle_tree import CommitmentTree, IncrementalWitness
from masp_tpu_torch.host.primitives.sapling import PaymentAddress, Rseed
from masp_tpu_torch.host.primitives.zip32 import ChildIndex, ExtendedSpendingKey, PseudoExtendedKey
from masp_tpu_torch.host.rng import XorShiftRng
from masp_tpu_torch.host.transaction.amount import I128, U64, ValueSum
from masp_tpu_torch.host.transaction.builder import Builder
from masp_tpu_torch.host.transaction.components.sapling import GROTH_PROOF_SIZE
from masp_tpu_torch.host.transaction.components.transparent import TransparentAddress
from masp_tpu_torch.host.transaction.transaction import Transaction

SEED = b"masp_tpu_torch wallet seed, 32 b"
HEIGHT = 10  # MASP active on TEST_NETWORK: ZIP-212 note seeds
ASSETS = (AssetType.new(b"wallet-asset-A"), AssetType.new(b"wallet-asset-B"))
# the two funding notes (A, B); the conversion burns one A for two B, taken
# CONVERTED times; the outputs (asset, value, recipient, memo, whether the
# sender's ovk can recover it): change to the sender's own address, a
# payment to the child address, and one to the child with no ovk; the
# transparent output and the fee, both in A. Each asset balances.
FUNDS = (60_000, 5_000)
CONVERTED = 2_000
OUTPUTS = ((0, 50_000, "self", b"change", True), (1, 6_000, "child", b"to the child account", True),
           (1, 3_000, "child", b"", False))
TRANSPARENT = 7_000
FEE = 1_000
STRANGERS = 4


@dataclass
class Wallet:
    """The keys, the tree leaves and the notes behind them.

    ``notes[i]`` is leaf i's note and its recipient, ``leaves[i]`` its
    commitment; the funding notes sit at ``positions``; ``conversions`` are
    the conversion tree's leaves, with ``allowed`` at ``conversion_pos``."""

    xsk: ExtendedSpendingKey
    child: ExtendedSpendingKey
    addr: PaymentAddress
    child_addr: PaymentAddress
    notes: list
    leaves: list
    positions: tuple
    allowed: AllowedConversion
    conversions: list
    conversion_pos: int

    def ivks(self) -> list:
        """The scanning ivks: the master account's, then the child's."""
        return [k.to_extended_full_viewing_key().fvk.vk.ivk() for k in (self.xsk, self.child)]


def make_wallet(seed: bytes, n_leaves: int, n_conversions: int) -> Wallet:
    """A master key from ``seed`` and its hardened child 0; n_leaves notes,
    the two funding notes at a third and four fifths of the way, the others
    seeded notes to the two addresses and to STRANGERS other wallets, in
    both assets; n_conversions seeded conversions with the wallet's own at
    a third of the way."""
    xsk = ExtendedSpendingKey.master(seed)
    child = xsk.derive_child(ChildIndex.hardened(0))
    addr, child_addr = xsk.default_address()[1], child.default_address()[1]
    strangers = [ExtendedSpendingKey.master(seed + bytes([i])).default_address()[1] for i in range(STRANGERS)]
    rng = XorShiftRng.from_seed(seed[:16])
    positions = (n_leaves // 3, n_leaves - n_leaves // 5)
    notes = []
    for i in range(n_leaves):
        if i in positions:
            k = positions.index(i)
            to, asset, value = addr, ASSETS[k], FUNDS[k]
        else:
            to = (addr, child_addr, strangers[(i // 4) % STRANGERS], strangers[(i // 4 + 1) % STRANGERS])[i % 4]
            asset, value = ASSETS[i % 2], 1 + rng.next_u64() % 100_000
        notes.append((to.create_note(asset, value, Rseed.after_zip212(rng.fill_bytes(32))), to))
    allowed = AllowedConversion.from_assets(
        ValueSum.from_pair(ASSETS[0], -1, I128) + ValueSum.from_pair(ASSETS[1], 2, I128))
    conversion_pos = n_conversions // 3
    conversions = []
    for i in range(n_conversions):
        if i == conversion_pos:
            conversions.append(allowed.commitment())
            continue
        a, b = (AssetType.new(b"wallet-epoch-%d-%d" % (i, k)) for k in (0, 1))
        rate = 1 + rng.next_u64() % 1_000
        conversions.append(AllowedConversion.from_assets(
            ValueSum.from_pair(a, -rate, I128) + ValueSum.from_pair(b, rate + 1, I128)).commitment())
    leaves = [note.commitment() for note, _ in notes]
    return Wallet(xsk, child, addr, child_addr, notes, leaves, positions, allowed, conversions, conversion_pos)


def host_paths(leaves: list, positions) -> tuple:
    """The host's incremental tree over ``leaves``: its root and, for each
    position, the IncrementalWitness path taken when the last leaf is in."""
    tree, witnesses = CommitmentTree.empty(), {}
    for i, leaf in enumerate(leaves):
        tree.append(leaf)
        for w in witnesses.values():
            w.append(leaf)
        if i in positions:
            witnesses[i] = IncrementalWitness.from_tree(tree)
    return tree.root(), [witnesses[p].path() for p in positions]


def outputs(w: Wallet) -> list:
    """The transaction's outputs, as add_sapling_output takes them:
    (ovk, to, asset_type, value, memo)."""
    to = {"self": w.addr, "child": w.child_addr}
    return [(w.xsk.expsk.ovk if recoverable else None, to[who], ASSETS[k], value,
             MemoBytes.from_bytes(memo) if memo else MemoBytes.empty())
            for k, value, who, memo, recoverable in OUTPUTS]


def builder(w: Wallet, spend_paths: list, conversion_path) -> Builder:
    """Builder(TEST_NETWORK, HEIGHT) with the two funding notes spent over
    ``spend_paths``, the conversion over ``conversion_path``, the outputs
    and the transparent output added."""
    b = Builder(TEST_NETWORK, HEIGHT)
    key = PseudoExtendedKey.from_spending_key(w.xsk)
    for pos, path in zip(w.positions, spend_paths):
        note, to = w.notes[pos]
        b.add_sapling_spend(key, to.diversifier, note, path)
    b.add_sapling_convert(w.allowed, CONVERTED, conversion_path)
    for out in outputs(w):
        b.add_sapling_output(*out)
    b.add_transparent_output(TransparentAddress(b"\x07" * 20), ASSETS[0], TRANSPARENT)
    return b


def fee() -> ValueSum:
    return ValueSum.from_pair(ASSETS[0], FEE, U64)


def compact_outputs(w: Wallet, indices) -> list:
    """(domain, output) for the notes at ``indices``, as a compact block
    carries them: the epk, the cmu and the first COMPACT_NOTE_SIZE (84)
    bytes of the note ciphertext, encrypted on the host with the note's
    ZIP-212 esk."""
    domain = SaplingDomain(TEST_NETWORK, HEIGHT)
    out = []
    for i in indices:
        note, to = w.notes[i]
        enc = NoteEncryption(domain, None, note, to, MemoBytes.empty())
        out.append((domain, SimpleNamespace(
            ephemeral_key=domain.epk_bytes(enc.epk), cmstar_bytes=note.cmu().to_bytes(),
            enc_ciphertext=enc.encrypt_note_plaintext()[:COMPACT_NOTE_SIZE])))
    return out


def expected_scan(w: Wallet, indices) -> list:
    """What a scan with ``ivks()`` must find at each of ``indices``: the
    ivk's index, 0 for the master address and 1 for the child's, or None."""
    return [{w.addr.to_bytes(): 0, w.child_addr.to_bytes(): 1}.get(w.notes[i][1].to_bytes()) for i in indices]


def without_proofs(tx) -> bytes:
    """A transaction's bytes with every zkproof zeroed; the transaction is
    left as it is. A rebuild from stored build parameters must give these
    bytes, since its proofs' (r, s) are drawn afresh."""
    copy = Transaction.from_bytes(tx.to_bytes())
    b = copy.sapling_bundle
    for kind in ("shielded_spends", "shielded_converts", "shielded_outputs"):
        setattr(b, kind, [replace(d, zkproof=bytes(GROTH_PROOF_SIZE)) for d in getattr(b, kind)])
    return copy.to_bytes()


def scan_key(found) -> tuple | None:
    """One scan result as bytes: the note's asset, value, rcm and recipient,
    and the ivk's index."""
    if found is None:
        return None
    (note, to), ivk_index = found
    return (note.asset_type.get_identifier(), note.value, note.rcm().to_bytes(), to.to_bytes(), ivk_index)


__all__ = [
    "SEED", "HEIGHT", "ASSETS", "Wallet", "make_wallet", "host_paths", "outputs", "builder", "fee",
    "compact_outputs", "expected_scan", "scan_key", "without_proofs",
]
