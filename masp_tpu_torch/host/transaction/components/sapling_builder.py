# Copy of masp_tpu/transaction/components/sapling_builder.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""SaplingBuilder + BuildParams
(masp_primitives/src/transaction/components/sapling/builder.rs):
randomness abstraction (Rng / Stored), anchor consistency, shuffle +
dummy-output padding, prover driving, apply_signatures."""

from __future__ import annotations

from dataclasses import dataclass, field

from masp_tpu_torch.host.fields import JubjubFr, Scalar
from masp_tpu_torch.host.note_encryption import NoteEncryption
from masp_tpu_torch.host.note_encryption.sapling_domain import SaplingDomain
from masp_tpu_torch.host.primitives import redjubjub
from masp_tpu_torch.host.primitives.asset_type import AssetType
from masp_tpu_torch.host.primitives.consensus import NetworkUpgrade
from masp_tpu_torch.host.primitives.convert import AllowedConversion
from masp_tpu_torch.host.primitives.memo import MemoBytes
from masp_tpu_torch.host.primitives.sapling import (
    Diversifier, Note, PaymentAddress, Rseed, spend_sig,
)
from masp_tpu_torch.host.transaction.amount import I64, I128, MAX_MONEY, ValueSum
from masp_tpu_torch.host.transaction.components.sapling import (
    Authorized, Bundle, ConvertDescription, OutputDescription, SpendDescription,
)
from masp_tpu_torch.host.rng import random_jubjub_fr

MIN_SHIELDED_OUTPUTS = 2


class BuilderError(Exception):
    ANCHOR_MISMATCH = "anchor mismatch"
    INVALID_ADDRESS = "invalid address"
    INVALID_AMOUNT = "invalid amount"
    SPEND_PROOF = "spend proof"
    CONVERT_PROOF = "convert proof"
    BINDING_SIG = "binding sig"


# --- BuildParams: all build randomness, replayable (builder.rs:50-383) -----


class BuildParams:
    def spend_rcv(self, i):
        raise NotImplementedError

    def spend_alpha(self, i):
        raise NotImplementedError

    def convert_rcv(self, i):
        raise NotImplementedError

    def output_rcv(self, i):
        raise NotImplementedError

    def output_rcm(self, i):
        raise NotImplementedError

    def output_rseed(self, i):
        raise NotImplementedError


@dataclass
class SpendBuildParams:
    rcv: JubjubFr
    alpha: JubjubFr


@dataclass
class ConvertBuildParams:
    rcv: JubjubFr


@dataclass
class OutputBuildParams:
    rcv: JubjubFr
    rcm: JubjubFr
    rseed: bytes


@dataclass
class StoredBuildParams(BuildParams):
    """Replayable randomness — deterministic rebuilds / hardware wallets."""

    spend_params: list[SpendBuildParams] = field(default_factory=list)
    convert_params: list[ConvertBuildParams] = field(default_factory=list)
    output_params: list[OutputBuildParams] = field(default_factory=list)

    def spend_rcv(self, i):
        return self.spend_params[i].rcv

    def spend_alpha(self, i):
        return self.spend_params[i].alpha

    def convert_rcv(self, i):
        return self.convert_params[i].rcv

    def output_rcv(self, i):
        return self.output_params[i].rcv

    def output_rcm(self, i):
        return self.output_params[i].rcm

    def output_rseed(self, i):
        return self.output_params[i].rseed

    def to_bytes(self) -> bytes:
        """Borsh serialization (sapling/builder.rs:249-283) — persists all
        build randomness for deterministic rebuilds / hardware wallets."""
        from masp_tpu_torch.host.transaction.borsh_io import stored_build_params_to_bytes

        return stored_build_params_to_bytes(self)

    @staticmethod
    def from_bytes(data: bytes) -> "StoredBuildParams":
        from masp_tpu_torch.host.transaction.borsh_io import stored_build_params_from_bytes

        return stored_build_params_from_bytes(data)


class RngBuildParams(BuildParams):
    """Lazily samples and memoizes randomness from an RNG."""

    def __init__(self, rng):
        self.rng = rng
        self.spends: dict[int, SpendBuildParams] = {}
        self.converts: dict[int, ConvertBuildParams] = {}
        self.outputs: dict[int, OutputBuildParams] = {}

    def _spend(self, i):
        if i not in self.spends:
            self.spends[i] = SpendBuildParams(
                rcv=random_jubjub_fr(self.rng), alpha=random_jubjub_fr(self.rng)
            )
        return self.spends[i]

    def _convert(self, i):
        if i not in self.converts:
            self.converts[i] = ConvertBuildParams(rcv=random_jubjub_fr(self.rng))
        return self.converts[i]

    def _output(self, i):
        if i not in self.outputs:
            self.outputs[i] = OutputBuildParams(
                rcv=random_jubjub_fr(self.rng),
                rcm=random_jubjub_fr(self.rng),
                rseed=self.rng.fill_bytes(32),
            )
        return self.outputs[i]

    def spend_rcv(self, i):
        return self._spend(i).rcv

    def spend_alpha(self, i):
        return self._spend(i).alpha

    def convert_rcv(self, i):
        return self._convert(i).rcv

    def output_rcv(self, i):
        return self._output(i).rcv

    def output_rcm(self, i):
        return self._output(i).rcm

    def output_rseed(self, i):
        return self._output(i).rseed

    def to_stored(self) -> StoredBuildParams:
        return StoredBuildParams(
            spend_params=[self.spends[i] for i in sorted(self.spends)],
            convert_params=[self.converts[i] for i in sorted(self.converts)],
            output_params=[self.outputs[i] for i in sorted(self.outputs)],
        )


# --- builder info records --------------------------------------------------


@dataclass
class SpendDescriptionInfo:
    extsk: object  # ExtendedSpendingKey / PseudoExtendedKey
    diversifier: Diversifier
    note: Note
    merkle_path: object


@dataclass
class ConvertDescriptionInfo:
    allowed: AllowedConversion
    value: int
    merkle_path: object


@dataclass
class SaplingOutputInfo:
    ovk: object
    to: PaymentAddress
    asset_type: AssetType
    value: int
    memo: MemoBytes


@dataclass
class SaplingMetadata:
    spend_indices: list[int] = field(default_factory=list)
    convert_indices: list[int] = field(default_factory=list)
    output_indices: list[int] = field(default_factory=list)

    @staticmethod
    def empty() -> "SaplingMetadata":
        return SaplingMetadata()

    def spend_index(self, n):
        return self.spend_indices[n] if n < len(self.spend_indices) else None

    def convert_index(self, n):
        return self.convert_indices[n] if n < len(self.convert_indices) else None

    def output_index(self, n):
        return self.output_indices[n] if n < len(self.output_indices) else None


@dataclass
class UnauthorizedBundle:
    """Bundle<Unauthorized>: spend_auth_sig slots hold the
    SpendDescriptionInfo until apply_signatures."""

    shielded_spends: list
    shielded_converts: list
    shielded_outputs: list
    value_balance: ValueSum
    tx_metadata: SaplingMetadata


def _shuffle(rng, items: list) -> None:
    """Fisher-Yates with the build RNG (indistinguishability shuffle).

    Uses rejection sampling for unbiased indices, matching rand's
    uniform shuffle semantics (the reference shuffles via rand's
    SliceRandom, components/sapling/builder.rs:918-928)."""
    for i in range(len(items) - 1, 0, -1):
        n = i + 1
        limit = (1 << 64) - ((1 << 64) % n)
        while True:
            r = rng.next_u64()
            if r < limit:
                break
        j = r % n
        items[i], items[j] = items[j], items[i]


class SaplingBuilder:
    def __init__(self, params, target_height: int):
        self.params = params
        self.target_height = target_height
        self.spend_anchor: int | None = None
        self.convert_anchor: int | None = None
        self.value_balance = ValueSum.zero(I128)
        self.spends: list[SpendDescriptionInfo] = []
        self.converts: list[ConvertDescriptionInfo] = []
        self.outputs: list[SaplingOutputInfo] = []

    def add_spend(self, extsk, diversifier: Diversifier, note: Note, merkle_path) -> None:
        node = note.commitment()
        path_root = merkle_path.root(node).to_scalar().n
        if self.spend_anchor is not None:
            if path_root != self.spend_anchor:
                raise BuilderError(BuilderError.ANCHOR_MISMATCH)
        else:
            self.spend_anchor = path_root
        self.value_balance = self.value_balance + ValueSum.from_pair(
            note.asset_type, note.value, I128
        )
        self.spends.append(SpendDescriptionInfo(extsk, diversifier, note, merkle_path))

    def add_convert(self, allowed: AllowedConversion, value: int, merkle_path) -> None:
        node = allowed.commitment()
        path_root = merkle_path.root(node).to_scalar().n
        if self.convert_anchor is not None:
            if path_root != self.convert_anchor:
                raise BuilderError(BuilderError.ANCHOR_MISMATCH)
        else:
            self.convert_anchor = path_root
        self.value_balance = self.value_balance + (allowed.assets.with_type(I128) * value)
        self.converts.append(ConvertDescriptionInfo(allowed, value, merkle_path))

    def add_output(self, ovk, to: PaymentAddress, asset_type: AssetType, value: int, memo: MemoBytes) -> None:
        if to.g_d() is None:
            raise BuilderError(BuilderError.INVALID_ADDRESS)
        if value > MAX_MONEY:
            raise BuilderError(BuilderError.INVALID_AMOUNT)
        self.value_balance = self.value_balance - ValueSum.from_pair(asset_type, value, I128)
        self.outputs.append(SaplingOutputInfo(ovk, to, asset_type, value, memo))

    def build(self, prover, ctx, rng, bparams, target_height: int,
              progress_notifier=None) -> UnauthorizedBundle | None:
        """Shuffle, pad to >= 2 outputs, drive the TxProver per description
        (builder.rs:888-1155)."""
        value_balance = self.value_balance
        indexed_spends = list(enumerate(self.spends))
        indexed_converts = list(enumerate(self.converts))
        indexed_outputs: list = [(i, o) for i, o in enumerate(self.outputs)]

        tx_metadata = SaplingMetadata(
            spend_indices=[0] * len(indexed_spends),
            convert_indices=[0] * len(indexed_converts),
            output_indices=[0] * len(indexed_outputs),
        )

        if indexed_spends:
            while len(indexed_outputs) < MIN_SHIELDED_OUTPUTS:
                indexed_outputs.append(None)

        _shuffle(rng, indexed_spends)
        _shuffle(rng, indexed_converts)
        _shuffle(rng, indexed_outputs)

        total_progress = len(indexed_spends) + len(indexed_outputs)
        progress = 0

        # --- phase A: collect proof jobs (all non-proof work, in the same
        # rng-draw order as the per-description path) ------------------------
        spend_jobs, spend_meta = [], []
        if indexed_spends:
            anchor = self.spend_anchor
            assert anchor is not None
            for i, (pos, spend) in enumerate(indexed_spends):
                pgk = spend.extsk.to_proof_generation_key()
                assert pgk is not None, "proof generation key must be known"
                nullifier = spend.note.nf(
                    pgk.to_viewing_key().nk, spend.merkle_path.position
                )
                tx_metadata.spend_indices[pos] = i
                spend_jobs.append(dict(
                    proof_generation_key=pgk, diversifier=spend.diversifier,
                    rseed=spend.note.rseed, ar=bparams.spend_alpha(i),
                    asset_type=spend.note.asset_type, value=spend.note.value,
                    anchor=anchor, merkle_path=spend.merkle_path,
                    rcv=bparams.spend_rcv(i),
                ))
                spend_meta.append((spend, nullifier, anchor))

        convert_jobs, convert_meta = [], []
        if indexed_converts:
            anchor = self.convert_anchor
            assert anchor is not None
            for i, (pos, convert) in enumerate(indexed_converts):
                tx_metadata.convert_indices[pos] = i
                convert_jobs.append(dict(
                    allowed_conversion=convert.allowed, value=convert.value,
                    anchor=anchor, merkle_path=convert.merkle_path,
                    rcv=bparams.convert_rcv(i),
                ))
                convert_meta.append(anchor)

        output_jobs, output_meta = [], []
        for i, output in enumerate(indexed_outputs):
            rseed = self._generate_rseed(bparams, i, target_height)
            if output is not None:
                pos, out_info = output
                tx_metadata.output_indices[pos] = i
                job, meta = self._prepare_output(rng, out_info, bparams.output_rcv(i), rseed)
            else:
                job, meta = self._prepare_dummy_output(rng, bparams.output_rcv(i), rseed)
            output_jobs.append(job)
            output_meta.append(meta)

        # --- phase B: prove — one pipelined batch per circuit kind when the
        # prover supports it (LocalTxProver on TPU), else per description ----
        if hasattr(prover, "prove_jobs"):
            spend_results, convert_results, output_results = prover.prove_jobs(
                ctx, spend_jobs, convert_jobs, output_jobs
            )
            progress = total_progress
            if progress_notifier:
                progress_notifier(progress, total_progress)
        else:
            spend_results, convert_results, output_results = [], [], []
            for job in spend_jobs:
                spend_results.append(prover.spend_proof(
                    ctx, job["proof_generation_key"], job["diversifier"],
                    job["rseed"], job["ar"], job["asset_type"], job["value"],
                    job["anchor"], job["merkle_path"], job["rcv"],
                ))
                progress += 1
                if progress_notifier:
                    progress_notifier(progress, total_progress)
            for job in convert_jobs:
                convert_results.append(prover.convert_proof(
                    ctx, job["allowed_conversion"], job["value"], job["anchor"],
                    job["merkle_path"], job["rcv"],
                ))
            for job in output_jobs:
                output_results.append(prover.output_proof(
                    ctx, job["esk"], job["payment_address"], job["rcm"],
                    job["asset_type"], job["value"], job["rcv"],
                ))
                progress += 1
                if progress_notifier:
                    progress_notifier(progress, total_progress)

        # --- phase C: assemble descriptions ---------------------------------
        shielded_spends = [
            SpendDescription(
                cv=cv, anchor=Scalar(anchor), nullifier=nullifier, rk=rk,
                zkproof=zkproof, spend_auth_sig=spend,
            )
            for (zkproof, cv, rk), (spend, nullifier, anchor)
            in zip(spend_results, spend_meta)
        ]
        shielded_converts = [
            ConvertDescription(cv=cv, anchor=Scalar(anchor), zkproof=zkproof)
            for (zkproof, cv), anchor in zip(convert_results, convert_meta)
        ]
        shielded_outputs = [
            self._assemble_output(rng, result, meta)
            for result, meta in zip(output_results, output_meta)
        ]

        if not shielded_spends and not shielded_outputs:
            return None
        return UnauthorizedBundle(
            shielded_spends=shielded_spends,
            shielded_converts=shielded_converts,
            shielded_outputs=shielded_outputs,
            value_balance=value_balance,
            tx_metadata=tx_metadata,
        )

    def _generate_rseed(self, bparams, i, target_height) -> Rseed:
        if self.params.is_nu_active(NetworkUpgrade.MASP, target_height):
            return Rseed.after_zip212(bparams.output_rseed(i))
        return Rseed.before_zip212(bparams.output_rcm(i))

    def _prepare_output(self, rng, out_info: SaplingOutputInfo, rcv, rseed):
        """Everything for a real output except the proof: note, esk, and
        the note encryptor (proof job + assembly metadata)."""
        note = Note(
            asset_type=out_info.asset_type,
            value=out_info.value,
            g_d=out_info.to.g_d(),
            pk_d=out_info.to.pk_d,
            rseed=rseed,
        )
        domain = SaplingDomain(self.params, self.target_height)
        esk = note.generate_or_derive_esk(rng)
        encryptor = NoteEncryption(domain, out_info.ovk, note, out_info.to, out_info.memo, esk=esk)
        job = dict(
            esk=encryptor.esk, payment_address=out_info.to, rcm=note.rcm(),
            asset_type=out_info.asset_type, value=out_info.value, rcv=rcv,
        )
        return job, ("real", note, domain, encryptor)

    def _assemble_output(self, rng, result, meta) -> OutputDescription:
        zkproof, cv = result
        if meta[0] == "real":
            _, note, domain, encryptor = meta
            cmu = note.cmu()
            enc_ciphertext = encryptor.encrypt_note_plaintext()
            out_ciphertext = encryptor.encrypt_outgoing_plaintext(cv, cmu, rng)
            return OutputDescription(
                cv=cv, cmu=cmu,
                ephemeral_key=domain.epk_bytes(encryptor.epk),
                enc_ciphertext=enc_ciphertext, out_ciphertext=out_ciphertext,
                zkproof=zkproof,
            )
        _, dummy_note, epk = meta
        from masp_tpu_torch.host.note_encryption import ENC_CIPHERTEXT_SIZE, OUT_CIPHERTEXT_SIZE

        return OutputDescription(
            cv=cv, cmu=dummy_note.cmu(), ephemeral_key=epk.to_bytes(),
            enc_ciphertext=rng.fill_bytes(ENC_CIPHERTEXT_SIZE),
            out_ciphertext=rng.fill_bytes(OUT_CIPHERTEXT_SIZE),
            zkproof=zkproof,
        )

    def _prepare_dummy_output(self, rng, rcv, rseed):
        """Dummy-output padding (builder.rs dummy note): random address and
        note, proof job + assembly metadata."""
        while True:
            d = Diversifier(rng.fill_bytes(11))
            g_d = d.g_d()
            if g_d is not None:
                break
        while True:
            dummy_ivk = random_jubjub_fr(rng)
            pk_d = g_d * dummy_ivk
            addr = PaymentAddress.from_parts(d, pk_d)
            if addr is not None:
                break
        dummy_note = Note(
            asset_type=AssetType.new(b"dummy"), value=0, g_d=g_d, pk_d=pk_d, rseed=rseed
        )
        esk = dummy_note.generate_or_derive_esk(rng)
        epk = g_d * esk
        job = dict(
            esk=esk, payment_address=addr, rcm=dummy_note.rcm(),
            asset_type=dummy_note.asset_type, value=dummy_note.value, rcv=rcv,
        )
        return job, ("dummy", dummy_note, epk)


def apply_signatures(bundle: UnauthorizedBundle, prover, ctx, rng, bparams,
                     sighash_bytes: bytes) -> tuple[Bundle, SaplingMetadata]:
    """binding sig + per-spend spend-auth sigs (builder.rs:1179-1214)."""
    binding_sig = prover.binding_sig(ctx, bundle.value_balance, sighash_bytes, rng)
    signed_spends = []
    for i, spend in enumerate(bundle.shielded_spends):
        info = spend.spend_auth_sig  # the SpendDescriptionInfo
        xsk = info.extsk.to_spending_key() if hasattr(info.extsk, "to_spending_key") else info.extsk
        assert xsk is not None, "spend authorization key must be known"
        ask = xsk.expsk.ask if hasattr(xsk, "expsk") else xsk.ask
        sig = spend_sig(
            redjubjub.PrivateKey(ask), bparams.spend_alpha(i), sighash_bytes, rng
        )
        signed_spends.append(
            SpendDescription(
                cv=spend.cv, anchor=spend.anchor, nullifier=spend.nullifier,
                rk=spend.rk, zkproof=spend.zkproof, spend_auth_sig=sig,
            )
        )
    return (
        Bundle(
            shielded_spends=signed_spends,
            shielded_converts=bundle.shielded_converts,
            shielded_outputs=bundle.shielded_outputs,
            value_balance=bundle.value_balance,
            authorization=Authorized(binding_sig=binding_sig),
        ),
        bundle.tx_metadata,
    )


__all__ = [
    "MIN_SHIELDED_OUTPUTS", "BuilderError", "BuildParams", "StoredBuildParams",
    "RngBuildParams", "SpendBuildParams", "ConvertBuildParams",
    "OutputBuildParams", "SaplingBuilder", "SaplingMetadata",
    "UnauthorizedBundle", "apply_signatures", "SpendDescriptionInfo",
    "ConvertDescriptionInfo", "SaplingOutputInfo",
]
