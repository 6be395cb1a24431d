# Copy of masp_tpu/transaction/builder.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""Top-level transaction builder (masp_primitives/src/transaction/builder.rs):
fee check, two-phase build (prove everything, then sighash + sign)."""

from __future__ import annotations

from dataclasses import dataclass

from masp_tpu_torch.host.primitives.consensus import BranchId
from masp_tpu_torch.host.transaction.amount import I128, ValueSum
from masp_tpu_torch.host.transaction.components.sapling_builder import (
    SaplingBuilder, SaplingMetadata, apply_signatures,
)
from masp_tpu_torch.host.transaction.components.transparent_builder import TransparentBuilder
from masp_tpu_torch.host.transaction.fees import FeeRule
from masp_tpu_torch.host.transaction.sighash import SignableInput, signature_hash
from masp_tpu_torch.host.transaction.transaction import Transaction, TransactionData, TxVersion
from masp_tpu_torch.host.transaction.txid import TxIdDigester


class BuildError(Exception):
    pass


class InsufficientFunds(BuildError):
    def __init__(self, missing: ValueSum):
        super().__init__(f"insufficient funds: missing {missing!r}")
        self.missing = missing


@dataclass
class Progress:
    cur: int
    end: int | None


class Builder:
    def __init__(self, params, target_height: int, expiry_height: int = 0):
        self.params = params
        self.target_height = target_height
        self.expiry_height = expiry_height
        self.transparent_builder = TransparentBuilder()
        self.sapling_builder = SaplingBuilder(params, target_height)
        self.progress_notifier = None

    # --- adders -----------------------------------------------------------
    def add_sapling_spend(self, extsk, diversifier, note, merkle_path):
        self.sapling_builder.add_spend(extsk, diversifier, note, merkle_path)

    def add_sapling_convert(self, allowed, value, merkle_path):
        self.sapling_builder.add_convert(allowed, value, merkle_path)

    def add_sapling_output(self, ovk, to, asset_type, value, memo):
        self.sapling_builder.add_output(ovk, to, asset_type, value, memo)

    def add_transparent_input(self, coin):
        self.transparent_builder.add_input(coin)

    def add_transparent_output(self, to, asset_type, value):
        self.transparent_builder.add_output(to, asset_type, value)

    def with_progress_notifier(self, notifier):
        self.progress_notifier = notifier

    def value_balance(self) -> ValueSum:
        return (
            self.transparent_builder.value_balance()
            + self.sapling_builder.value_balance
        )

    # --- build ------------------------------------------------------------
    def build(self, prover, fee_rule: FeeRule, rng, bparams) -> tuple[Transaction, SaplingMetadata]:
        fee = fee_rule.fee_required(
            self.params,
            self.target_height,
            self.transparent_builder.outputs(),
            len(self.sapling_builder.spends),
            len(self.sapling_builder.outputs),
        )
        return self._build_internal(prover, fee, rng, bparams)

    def _build_internal(self, prover, fee: ValueSum, rng, bparams):
        consensus_branch_id = BranchId.for_height(self.params, self.target_height)
        version = TxVersion.suggested_for_branch(consensus_branch_id)

        balance_after_fees = self.value_balance() - fee.with_type(I128)
        if not balance_after_fees.is_zero():
            raise InsufficientFunds(-balance_after_fees)

        transparent_bundle = self.transparent_builder.build()
        ctx = prover.new_sapling_proving_context()
        unauthed_bundle = self.sapling_builder.build(
            prover, ctx, rng, bparams, self.target_height, self.progress_notifier
        )

        # sighash over the unauthorized tx (witness data not yet present)
        sap_view = (
            _UnauthedBundleView(unauthed_bundle) if unauthed_bundle is not None else None
        )
        unauthed_tx = TransactionData(
            version, consensus_branch_id, 0, self.expiry_height,
            transparent_bundle, sap_view,
        )
        txid_parts = unauthed_tx.digest(TxIdDigester())
        shielded_sig_commitment = signature_hash(
            unauthed_tx, SignableInput.shielded(), txid_parts
        )

        if unauthed_bundle is not None:
            sapling_bundle, tx_metadata = apply_signatures(
                unauthed_bundle, prover, ctx, rng, bparams, shielded_sig_commitment
            )
        else:
            sapling_bundle, tx_metadata = None, SaplingMetadata.empty()

        authorized_tx = TransactionData(
            version, consensus_branch_id, 0, self.expiry_height,
            transparent_bundle, sapling_bundle,
        )
        return authorized_tx.freeze(), tx_metadata


class _UnauthedBundleView:
    """Adapter exposing an UnauthorizedBundle with the Bundle interface needed
    by the txid digester (the txid tree does not touch witness data)."""

    def __init__(self, inner):
        self._inner = inner

    def __bool__(self):
        return self._inner is not None

    def is_empty(self):
        return self._inner is None or (
            not self._inner.shielded_spends
            and not self._inner.shielded_converts
            and not self._inner.shielded_outputs
        )

    @property
    def shielded_spends(self):
        return self._inner.shielded_spends if self._inner else []

    @property
    def shielded_converts(self):
        return self._inner.shielded_converts if self._inner else []

    @property
    def shielded_outputs(self):
        return self._inner.shielded_outputs if self._inner else []

    @property
    def value_balance(self):
        return self._inner.value_balance if self._inner else ValueSum.zero(I128)


__all__ = ["Builder", "BuildError", "InsufficientFunds", "Progress"]
