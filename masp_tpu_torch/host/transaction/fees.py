# Copy of masp_tpu/transaction/fees.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""Fee rules (masp_primitives/src/transaction/fees*)."""

from __future__ import annotations

from masp_tpu_torch.host.transaction.amount import U64, ValueSum, default_fee


class FeeRule:
    def fee_required(self, params, target_height, transparent_outputs,
                     sapling_input_count, sapling_output_count) -> ValueSum:
        raise NotImplementedError


class FixedFeeRule(FeeRule):
    """Fixed fee regardless of transaction structure (fees/fixed.rs)."""

    def __init__(self, fixed_fee: ValueSum | None = None):
        self.fixed_fee = fixed_fee if fixed_fee is not None else default_fee()

    @staticmethod
    def standard() -> "FixedFeeRule":
        return FixedFeeRule(default_fee())

    @staticmethod
    def non_standard(fee: ValueSum) -> "FixedFeeRule":
        return FixedFeeRule(fee)

    def fee_required(self, params, target_height, transparent_outputs,
                     sapling_input_count, sapling_output_count) -> ValueSum:
        return self.fixed_fee


__all__ = ["FeeRule", "FixedFeeRule"]
