#!/usr/bin/env python3
"""Proving throughput of the port: Spend (or Output, Convert) Groth16 proofs
per second on one card.

The twin of bench.py's worker (bench.py:188-307): the same environment
variables, fixtures, warm-up and timed loop, the same metric strings and the
same keys on its one JSON line (metric, value, unit, vs_baseline, median_s,
min_s, max_s, iters), printed and logged through utils/benchlog.py. It runs
in-process and exits non-zero on any failure: bench.py's orchestrator (the
backend probe, retries, and the fallback to a logged result) is not ported,
so no stale number is ever reported in place of a measurement.

One departure in what is measured: in stream mode bench.py reports
``[dt / n_total] * iters``, one total divided into equal parts
(bench.py:247-261). Here every sample is a clock reading actually taken:
the stream's lazy witness iterator reads the clock when the batch prover
pulls the first witness of each batch-sized window (the prover pulls
witness j only after draining proof j - W - 1, W = MASP_BATCH_WINDOW), and
once more when the call returns; each sample is one window's delta over
the batch. The line's "sampled" key says how its samples were taken.

Env:
  MASP_BENCH_CIRCUIT=spend|output|convert   (default spend)
  MASP_BENCH_ITERS=N                (default 5; a warm-up proof always runs first)
  MASP_BENCH_BATCH=B                (B proofs through the batch prover per
                                     iteration; per-proof times reported)
  MASP_BENCH_STREAM=1               (with BATCH: one stream of iters*B proofs,
                                     one sample per B-proof window)
  MASP_TRACE=1                      (print the span table to stderr)
  MASP_PROFILE=<dir>                (a torch.profiler trace of the timed loop)

    python3 -m masp_tpu_torch.tools.bench                 # on the card
    python3 -m masp_tpu_torch.tools.bench --device cpu    # plain kernels; tiny circuits only

Parameters come from groth16.params_io.cached_test_params under
.params_cache/ (generated on the device when absent).
"""

from __future__ import annotations

import functools
import os
import sys
import time
from contextlib import contextmanager

REF_SPEND_SECONDS = 2.0  # bench.py's documented assumption (BASELINE.md)
REF_OUTPUT_SECONDS = 0.6
REF_CONVERT_SECONDS = 1.0
REF_SECONDS = {"spend": REF_SPEND_SECONDS, "output": REF_OUTPUT_SECONDS, "convert": REF_CONVERT_SECONDS}

SAMPLED = {
    "single": "one per proof: the clock around witness synthesis and the proof",
    "batch": "one per iteration: the clock around B witnesses and the batch prover's call, over B",
    "stream": "one per B-proof window of one stream: the clock when the batch prover pulls the window's "
              "first witness (and when the call returns), the window's delta over B",
}


def metric_name(circuit_kind: str, batch: int) -> str:
    label = f" (batch {batch})" if batch > 1 else ""
    return f"{circuit_kind}-circuit Groth16 proofs/sec/chip{label}"


def _metric_name() -> str:
    """bench.py's metric name, from its environment variables."""
    return metric_name(os.environ.get("MASP_BENCH_CIRCUIT", "spend"), int(os.environ.get("MASP_BENCH_BATCH", "0")))


def device_arg(argv, default: str = "cuda") -> str:
    """The value of ``--device`` in argv (``--device cpu`` or
    ``--device=cpu``), else ``default``."""
    for i, a in enumerate(argv):
        if a == "--device" and i + 1 < len(argv):
            return argv[i + 1]
        if a.startswith("--device="):
            return a.split("=", 1)[1]
    return default


def fixture_and_params(kind: str, device):
    """(make_circuit, public_inputs, params, rng) of circuit ``kind`` as
    bench.py draws them: the fixture from an XorShiftRng seeded with
    bytes(range(16)), then the cached test parameters from the same rng,
    which is returned after those draws."""
    from masp_tpu_torch.groth16.params_io import cached_test_params
    from masp_tpu_torch.host.circuits.convert import Convert
    from masp_tpu_torch.host.circuits.sapling import Output, Spend
    from masp_tpu_torch.host.rng import XorShiftRng
    from masp_tpu_torch.tools import fixtures

    if kind not in REF_SECONDS:
        raise SystemExit(f"unknown MASP_BENCH_CIRCUIT={kind!r} (expected spend, output, or convert)")
    rng = XorShiftRng.from_seed(fixtures.BENCH_SEED)
    make = {"spend": fixtures._spend_fixture, "output": fixtures._output_fixture,
            "convert": fixtures._convert_fixture}[kind]
    make_circuit, public_inputs = make(rng)
    cls = {"spend": Spend, "output": Output, "convert": Convert}[kind]
    with device_routes(device):
        params = cached_test_params(f"{kind}-test", cls, rng)
    return make_circuit, public_inputs, params, rng


@contextmanager
def device_routes(device):
    """Within the block, the device twins that the copied host modules call
    with their default device ("cuda") run on ``device``: the batch
    prover (reached by prove_jobs), the parameter generator (reached by
    cached_test_params), the device pairing (verify_proofs_batch) and the
    RedJubjub device batch (redjubjub.batch_verify). The copies import each
    of them when called, so the module attribute is what they reach. On
    the card this changes nothing; with ``device="cpu"`` those routes run
    their plain versions."""
    from masp_tpu_torch import resolve_device
    from masp_tpu_torch.groth16 import generator, prover
    from masp_tpu_torch.ops import jubjub, pairing

    dev = resolve_device(device)
    saved = [(mod, name, getattr(mod, name)) for mod, name in (
        (prover, "create_proofs_from_assemblies"), (generator, "generate_random_parameters"),
        (pairing, "pairing_product_is_one_device"), (jubjub, "batch_verify_device"))]
    try:
        for mod, name, fn in saved:
            setattr(mod, name, functools.partial(fn, device=dev))
        yield dev
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def measure(make_circuit, params, public_inputs, iters: int, batch: int = 0, stream: bool = False,
            device="cuda", clock=time.perf_counter, kind: str = "spend") -> tuple[dict, list]:
    """bench.py's worker from the warm-up to the result: the device copies of
    the parameters, one warm-up proof checked by the host verifier, then the
    timed loop in single (batch <= 1), batch or stream mode, then the last
    proof checked. Returns (result, raw samples in seconds per proof, in the
    order taken). ``clock`` is read only at the samples' edges; ``kind``
    names the circuit in the metric and picks the baseline."""
    from masp_tpu_torch import resolve_device
    from masp_tpu_torch.groth16.prover import (
        create_proof_from_assembly, create_proofs_from_assemblies, prepare_device_params,
        synthesize_witness,
    )
    from masp_tpu_torch.host.structures import prepare_verifying_key
    from masp_tpu_torch.host.verifier import verify_proof
    from masp_tpu_torch.utils import tracing

    dev = resolve_device(device)
    if iters < 1:
        raise ValueError("need at least one timed iteration")
    pvk = prepare_verifying_key(params.vk)
    prepare_device_params(params, dev)

    cs = synthesize_witness(make_circuit())
    proof = create_proof_from_assembly(cs, params, 11, 22, device=dev)
    if not verify_proof(pvk, proof, public_inputs):
        raise AssertionError("benchmark proof failed to verify")

    mode = "single" if batch <= 1 else "stream" if stream else "batch"
    tracing.reset()
    samples = []
    with tracing.device_profile(os.environ.get("MASP_PROFILE")):
        if mode == "stream":
            n_total = iters * batch
            rs = [(100 + j, 200 + j) for j in range(n_total)]
            edges = []

            def witnesses():
                for j in range(n_total):
                    if j % batch == 0:
                        edges.append(clock())
                    yield synthesize_witness(make_circuit())

            proofs = create_proofs_from_assemblies(witnesses(), params, rs, device=dev)
            edges.append(clock())
            samples = [(b - a) / batch for a, b in zip(edges, edges[1:])]
            proof = proofs[-1]
        elif mode == "batch":
            for i in range(iters):
                t0 = clock()
                rs = [(100 + i + j, 200 + i + j) for j in range(batch)]
                css = (synthesize_witness(make_circuit()) for _ in range(batch))
                proofs = create_proofs_from_assemblies(css, params, rs, device=dev)
                samples.append((clock() - t0) / batch)
            proof = proofs[-1]
        else:
            for i in range(iters):
                t0 = clock()
                cs = synthesize_witness(make_circuit())
                proof = create_proof_from_assembly(cs, params, 100 + i, 200 + i, device=dev)
                samples.append(clock() - t0)
    if not verify_proof(pvk, proof, public_inputs):
        raise AssertionError("the last timed proof failed to verify")
    if os.environ.get("MASP_TRACE") == "1":
        print(tracing.report(), file=sys.stderr)

    raw = list(samples)
    samples.sort()
    n = len(samples)
    median = samples[n // 2] if n % 2 else (samples[n // 2 - 1] + samples[n // 2]) / 2
    throughput = 1.0 / median
    result = {
        "metric": metric_name(kind, batch),
        "value": round(throughput, 4),
        "unit": "proofs/s",
        "vs_baseline": round(throughput * REF_SECONDS[kind], 3),
        "median_s": round(median, 4),
        "min_s": round(samples[0], 4),
        "max_s": round(samples[-1], 4),
        "iters": n,
        "sampled": SAMPLED[mode],
    }
    return result, raw


def main(argv=None) -> int:
    from masp_tpu_torch import resolve_device
    from masp_tpu_torch.utils import benchlog

    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device(device_arg(argv))
    kind = os.environ.get("MASP_BENCH_CIRCUIT", "spend")
    iters = int(os.environ.get("MASP_BENCH_ITERS", "5"))
    batch = int(os.environ.get("MASP_BENCH_BATCH", "0"))
    stream = os.environ.get("MASP_BENCH_STREAM") == "1"
    make_circuit, public_inputs, params, _ = fixture_and_params(kind, dev)
    result, raw = measure(make_circuit, params, public_inputs, iters, batch, stream, dev, kind=kind)
    benchlog.emit(result, raw, device=str(dev), circuit=kind, batch=batch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
