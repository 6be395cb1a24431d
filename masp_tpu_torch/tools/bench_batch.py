#!/usr/bin/env python3
"""Batch proving throughput of the port (create_proofs_from_assemblies)
against one-at-a-time proving, per proof, on one card.

The twin of tools/bench_batch.py:31-80: bench.py's Output (or Spend)
fixture and cached test parameters, a warm-up proof, then B proofs one at a
time, the same B witnesses through the batch prover (prove only), and B new
witnesses synthesised lazily through the batch prover (synthesis
overlapping the device). Prints the source's line. Departure: it also prints
and logs one JSON line through utils/benchlog.py with the three per-proof
times, each one window of B proofs on the clock over B.

Env: MASP_BENCH_CIRCUIT=output|spend (default output), MASP_BENCH_B=8.

    python3 -m masp_tpu_torch.tools.bench_batch                 # on the card
    python3 -m masp_tpu_torch.tools.bench_batch --device cpu    # plain kernels; tiny circuits only
"""

from __future__ import annotations

import os
import sys
import time


def measure(make_circuit, params, public_inputs, batch: int, kind: str = "output", device="cuda",
            clock=time.perf_counter) -> dict:
    """The source's three windows after a warm-up; every proof must pass
    the host verifier (the source checks the serial run's last and the
    synthesising run's last).
    Returns the result: per-proof seconds of each window and the speedup."""
    from masp_tpu_torch import resolve_device
    from masp_tpu_torch.groth16.prover import (
        create_proof_from_assembly, create_proofs_from_assemblies, prepare_device_params,
        synthesize_witness,
    )
    from masp_tpu_torch.host.structures import prepare_verifying_key
    from masp_tpu_torch.host.verifier import verify_proof

    dev = resolve_device(device)
    pvk = prepare_verifying_key(params.vk)
    prepare_device_params(params, dev)

    cs = synthesize_witness(make_circuit())
    proof = create_proof_from_assembly(cs, params, 11, 22, device=dev)
    if not verify_proof(pvk, proof, public_inputs):
        raise AssertionError("the warm-up proof failed to verify")

    # serial: B proofs one at a time
    t0 = clock()
    css, proofs = [], []
    for i in range(batch):
        cs = synthesize_witness(make_circuit())
        css.append(cs)
        proofs.append(create_proof_from_assembly(cs, params, 100 + i, 200 + i, device=dev))
    serial = (clock() - t0) / batch
    if not all(verify_proof(pvk, p, public_inputs) for p in proofs):
        raise AssertionError("a serial proof failed to verify")

    # batched: the serial run's witnesses, so this isolates the prove pipeline
    t0 = clock()
    proofs = create_proofs_from_assemblies(css, params, [(100 + i, 200 + i) for i in range(batch)], device=dev)
    batched = (clock() - t0) / batch
    if not all(verify_proof(pvk, p, public_inputs) for p in proofs):
        raise AssertionError("a batched proof failed to verify")

    # batched with synthesis: a lazy generator, so synthesis overlaps the device
    t0 = clock()
    css2 = (synthesize_witness(make_circuit()) for _ in range(batch))
    proofs = create_proofs_from_assemblies(css2, params, [(300 + i, 400 + i) for i in range(batch)], device=dev)
    e2e = (clock() - t0) / batch
    if not all(verify_proof(pvk, p, public_inputs) for p in proofs):
        raise AssertionError("a batched proof (synthesis included) failed to verify")

    print(f"{kind} B={batch}: serial {serial:.3f}s/proof | "
          f"batched(prove-only) {batched:.3f}s/proof | "
          f"batched(e2e) {e2e:.3f}s/proof | "
          f"speedup {serial/e2e:.2f}x", flush=True)
    return {
        "metric": f"{kind} batch proving (B={batch}), witness synthesis included",
        "value": round(e2e, 4),
        "unit": "s/proof",
        "serial_s": round(serial, 4),
        "batched_prove_only_s": round(batched, 4),
        "speedup": round(serial / e2e, 3),
        "sampled": "one window of B proofs each on the clock, over B",
    }


def main(argv=None) -> int:
    from masp_tpu_torch import resolve_device
    from masp_tpu_torch.tools.bench import device_arg, fixture_and_params
    from masp_tpu_torch.utils import benchlog

    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device(device_arg(argv))
    kind = os.environ.get("MASP_BENCH_CIRCUIT", "output")
    if kind not in ("output", "spend"):
        raise SystemExit(f"unknown MASP_BENCH_CIRCUIT={kind!r} (expected output or spend)")
    batch = int(os.environ.get("MASP_BENCH_B", "8"))
    make_circuit, public_inputs, params, _ = fixture_and_params(kind, dev)
    result = measure(make_circuit, params, public_inputs, batch, kind, dev)
    benchlog.emit(result, device=str(dev), circuit=kind, batch=batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
