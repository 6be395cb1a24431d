#!/usr/bin/env python3
"""Full multi-asset transaction through the port (BASELINE.json config #4):
Spend + Convert + 2 Outputs, real Groth16 proving via LocalTxProver on the
card, binding signature, then BatchValidator verification.

The twin of tools/bench_tx.py:49-123: the same wallet, notes, conversion
and fee, the same two metric strings and units, each line printed and
logged with its samples through utils/benchlog.py. Parameters come from
groth16.params_io.cached_test_params (generated on the device when absent).

Env: MASP_TX_ITERS (default 3).

    python3 -m masp_tpu_torch.tools.bench_tx                 # on the card
    python3 -m masp_tpu_torch.tools.bench_tx --device cpu    # plain kernels: real circuits take hours
"""

from __future__ import annotations

import os
import sys
import time


def median(samples: list) -> float:
    """The sources' median: the middle of the sorted samples (the upper
    one of an even count)."""
    return sorted(samples)[len(samples) // 2]


def timed(fn, iters: int, clock=time.perf_counter) -> tuple:
    """fn() once to warm up, then ``iters`` calls each on the clock:
    (the last call's result, the samples)."""
    out = fn()
    samples = []
    for _ in range(iters):
        t0 = clock()
        out = fn()
        samples.append(clock() - t0)
    return out, samples


def validation(tx, prover, rng):
    """The sources' check of a built transaction: check_bundle, then
    BatchValidator.validate; raises where they assert."""
    from masp_tpu_torch.groth16.sapling_prover import BatchValidator
    from masp_tpu_torch.host.transaction.sighash import SignableInput, signature_hash
    from masp_tpu_torch.host.transaction.txid import TxIdDigester

    txid_parts = tx.data.digest(TxIdDigester())
    sighash = signature_hash(tx.data, SignableInput.shielded(), txid_parts)

    def validate():
        v = BatchValidator()
        if not v.check_bundle(tx.sapling_bundle, sighash):
            raise AssertionError("check_bundle rejected the transaction")
        if not v.validate(prover.spend_vk, prover.convert_vk, prover.output_vk, rng=rng):
            raise AssertionError("BatchValidator rejected the transaction")

    return validate


def measure(prover, rng, iters: int, device="cuda", clock=time.perf_counter) -> list:
    """The source's build and validation after their warm-ups, ``iters``
    timed runs each; ``prover`` is a LocalTxProver, ``rng`` the source's
    XorShiftRng after the parameters' draws. Every build's bundle must pass
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

    xsk = ExtendedSpendingKey.master(b"bench tx wallet")
    _idx, addr = xsk.default_address()
    asset_a = AssetType.new(b"bench-asset-A")
    asset_b = AssetType.new(b"bench-asset-B")
    note = addr.create_note(asset_a, 10_000, Rseed.after_zip212(rng.fill_bytes(32)))
    tree = CommitmentTree.empty()
    tree.append(note.commitment())
    witness = IncrementalWitness.from_tree(tree)
    allowed = AllowedConversion.from_assets(
        ValueSum.from_pair(asset_a, -1, I128) + ValueSum.from_pair(asset_b, 2, I128)
    )
    ctree = CommitmentTree.empty()
    ctree.append(allowed.commitment())
    cwitness = IncrementalWitness.from_tree(ctree)
    fee = ValueSum.from_pair(asset_a, 1_000, U64)

    def build_tx():
        builder = Builder(TEST_NETWORK, 10)
        builder.add_sapling_spend(
            PseudoExtendedKey.from_spending_key(xsk), addr.diversifier, note,
            witness.path(),
        )
        builder.add_sapling_convert(allowed, 2_000, cwitness.path())
        builder.add_sapling_output(xsk.expsk.ovk, addr, asset_a, 7_000, MemoBytes.empty())
        builder.add_sapling_output(xsk.expsk.ovk, addr, asset_b, 4_000, MemoBytes.empty())
        tx, _meta = builder.build(
            prover, FixedFeeRule.non_standard(fee), rng, RngBuildParams(rng)
        )
        return tx

    with device_routes(device):
        tx, build_s = timed(build_tx, iters, clock)
        _, validate_s = timed(validation(tx, prover, rng), iters, clock)
    return [({
        "metric": "full tx build+prove (1 spend, 1 convert, 2 outputs)",
        "value": round(median(build_s), 3),
        "unit": "s/tx",
    }, build_s), ({
        "metric": "full tx batch-validate (4 proofs + 2 sig batches)",
        "value": round(median(validate_s) * 1000, 1),
        "unit": "ms/tx",
    }, validate_s)]


def local_prover(device):
    """A LocalTxProver over the three circuits' cached test parameters,
    drawn from bench.py's seeded rng in the source's order (Spend, Output,
    Convert); returns (prover, rng)."""
    from masp_tpu_torch.groth16.local_prover import LocalTxProver
    from masp_tpu_torch.groth16.params_io import cached_test_params
    from masp_tpu_torch.host.circuits.convert import Convert
    from masp_tpu_torch.host.circuits.sapling import Output, Spend
    from masp_tpu_torch.host.rng import XorShiftRng
    from masp_tpu_torch.tools.bench import device_routes
    from masp_tpu_torch.tools.fixtures import BENCH_SEED

    rng = XorShiftRng.from_seed(BENCH_SEED)
    with device_routes(device):
        prover = LocalTxProver(
            spend_params=cached_test_params("spend-test", Spend, rng),
            output_params=cached_test_params("output-test", Output, rng),
            convert_params=cached_test_params("convert-test", Convert, rng),
        )
    return prover, rng


def main(argv=None) -> int:
    from masp_tpu_torch import resolve_device
    from masp_tpu_torch.tools.bench import device_arg
    from masp_tpu_torch.utils import benchlog

    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device(device_arg(argv))
    iters = int(os.environ.get("MASP_TX_ITERS", "3"))
    prover, rng = local_prover(dev)
    for result, samples in measure(prover, rng, iters, dev):
        benchlog.emit(result, samples, device=str(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
