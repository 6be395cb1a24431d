#!/usr/bin/env python3
"""Mixed 64-proof bundle through the port: one transaction with 8 Spends, 8
Converts and 48 Outputs built through the two-phase SaplingBuilder, proved
via LocalTxProver.prove_jobs (one pipelined stream per circuit kind) on the
card, then verified with one BatchValidator.validate.

The twin of tools/bench_mixed_batch.py: the same wallet, notes, conversion,
fee and output plan, the same two metric strings and units, each line
printed and logged with its samples through utils/benchlog.py. The counts
are arguments of ``measure`` (the source's by default); the output plan
keeps the source's shape at any count: two Outputs of 2,000 B a Convert,
the rest of A at 2,000 each but the last, which takes what balances.

Env: MASP_MIXED_ITERS (default 2).

    python3 -m masp_tpu_torch.tools.bench_mixed_batch    # on the card
"""

from __future__ import annotations

import os
import sys
import time

N_SPENDS, N_CONVERTS, N_OUTPUTS = 8, 8, 48


def out_plan(asset_a, asset_b, n_spends: int, n_converts: int, n_outputs: int) -> list:
    """(asset, value) of each Output: spends bring 10,000 A each, each
    Convert of 2,000 burns 2,000 A and mints 4,000 B, the fee is 1,000 A.
    At the source's counts: 31 x 2,000 A, 1,000 A, 16 x 2,000 B."""
    n_b = 2 * n_converts
    n_a = n_outputs - n_b
    last = 10_000 * n_spends - 2_000 * n_converts - 1_000 - 2_000 * (n_a - 1)
    if n_a < 1 or last <= 0:
        raise ValueError(f"{n_outputs} outputs cannot balance {n_spends} spends and {n_converts} converts")
    return [(asset_a, 2_000)] * (n_a - 1) + [(asset_a, last)] + [(asset_b, 2_000)] * n_b


def measure(prover, rng, iters: int, n_spends: int = N_SPENDS, n_converts: int = N_CONVERTS,
            n_outputs: int = N_OUTPUTS, device="cuda", clock=time.perf_counter) -> list:
    """The source's bundle build and validation after their warm-ups,
    ``iters`` timed runs each; ``prover`` is a LocalTxProver, ``rng`` the
    source's XorShiftRng after the parameters' draws. Every bundle must pass
    check_bundle and validate. Returns [(result, samples)] for the build and
    the validation."""
    from masp_tpu_torch.host.primitives.asset_type import AssetType
    from masp_tpu_torch.host.primitives.consensus import TEST_NETWORK
    from masp_tpu_torch.host.primitives.convert import AllowedConversion
    from masp_tpu_torch.host.primitives.memo import MemoBytes
    from masp_tpu_torch.host.primitives.merkle_tree import CommitmentTree, IncrementalWitness
    from masp_tpu_torch.host.primitives.sapling import Rseed
    from masp_tpu_torch.host.primitives.zip32 import ExtendedSpendingKey, PseudoExtendedKey
    from masp_tpu_torch.host.transaction.amount import I128, U64, ValueSum
    from masp_tpu_torch.host.transaction.builder import Builder
    from masp_tpu_torch.host.transaction.components.sapling_builder import RngBuildParams
    from masp_tpu_torch.host.transaction.fees import FixedFeeRule
    from masp_tpu_torch.tools.bench import device_routes
    from masp_tpu_torch.tools.bench_tx import median, timed, validation

    xsk = ExtendedSpendingKey.master(b"mixed batch wallet")
    _idx, addr = xsk.default_address()
    asset_a = AssetType.new(b"mixed-asset-A")
    asset_b = AssetType.new(b"mixed-asset-B")

    # the notes of asset A in one tree, each witness tracking later appends
    tree = CommitmentTree.empty()
    notes, witnesses = [], []
    for _i in range(n_spends):
        note = addr.create_note(asset_a, 10_000, Rseed.after_zip212(rng.fill_bytes(32)))
        tree.append(note.commitment())
        for w in witnesses:
            w.append(note.commitment())
        notes.append(note)
        witnesses.append(IncrementalWitness.from_tree(tree))

    allowed = AllowedConversion.from_assets(
        ValueSum.from_pair(asset_a, -1, I128) + ValueSum.from_pair(asset_b, 2, I128)
    )
    ctree = CommitmentTree.empty()
    ctree.append(allowed.commitment())
    cwitness = IncrementalWitness.from_tree(ctree)
    fee = ValueSum.from_pair(asset_a, 1_000, U64)
    plan = out_plan(asset_a, asset_b, n_spends, n_converts, n_outputs)

    def build_tx():
        builder = Builder(TEST_NETWORK, 10)
        for note, w in zip(notes, witnesses):
            builder.add_sapling_spend(
                PseudoExtendedKey.from_spending_key(xsk), addr.diversifier,
                note, w.path(),
            )
        for _ in range(n_converts):
            builder.add_sapling_convert(allowed, 2_000, cwitness.path())
        for asset, value in plan:
            builder.add_sapling_output(
                xsk.expsk.ovk, addr, asset, value, MemoBytes.empty()
            )
        tx, _meta = builder.build(
            prover, FixedFeeRule.non_standard(fee), rng, RngBuildParams(rng)
        )
        return tx

    n_proofs = n_spends + n_converts + len(plan)
    with device_routes(device):
        tx, build_s = timed(build_tx, iters, clock)
        _, validate_s = timed(validation(tx, prover, rng), iters, clock)
    build, check = median(build_s), median(validate_s)
    return [({
        "metric": f"mixed batch build+prove ({n_spends} spend, {n_converts} "
                  f"convert, {len(plan)} output = {n_proofs} proofs)",
        "value": round(build, 3),
        "unit": "s/batch",
        "s_per_proof": round(build / n_proofs, 4),
    }, build_s), ({
        "metric": f"mixed batch validate ({n_proofs} proofs + sig batches)",
        "value": round(check, 3),
        "unit": "s/batch",
        "ms_per_proof": round(check * 1000 / n_proofs, 1),
    }, validate_s)]


def main(argv=None) -> int:
    from masp_tpu_torch import resolve_device
    from masp_tpu_torch.tools.bench import device_arg
    from masp_tpu_torch.tools.bench_tx import local_prover
    from masp_tpu_torch.utils import benchlog

    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device(device_arg(argv))
    iters = int(os.environ.get("MASP_MIXED_ITERS", "2"))
    prover, rng = local_prover(dev)
    for result, samples in measure(prover, rng, iters, device=dev):
        benchlog.emit(result, samples, device=str(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
