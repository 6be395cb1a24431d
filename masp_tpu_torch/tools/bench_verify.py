#!/usr/bin/env python3
"""Batch verification through the port: the Groth16 batch check with the
host pairing and with the device pairing (ops/pairing.py on the card), and
RedJubjub signature batches on the host and as one device Jubjub MSM.

The twin of tools/bench_verify.py:45-100: one real Output proof (bench.py's
fixture, the cached test parameters) replicated B times, the same four
configurations, rng seeds and metric strings, each line printed and logged
with its samples through utils/benchlog.py.

Env: MASP_VERIFY_BATCH (default 8), MASP_VERIFY_ITERS (default 3),
MASP_VERIFY_SKIP_DEVICE_PAIRING=1 (leave out the device pairing).

    python3 -m masp_tpu_torch.tools.bench_verify    # on the card
"""

from __future__ import annotations

import os
import sys
import time


def measure(pvk, proof, public_inputs, rng, batch: int, iters: int, device="cuda",
            skip_device_pairing: bool = False, clock=time.perf_counter) -> list:
    """The source's four timed batch checks, each after a warm-up call that
    must accept: the Groth16 batch of ``batch`` copies of ``proof`` on the
    host pairing and (unless skipped) the device pairing, then ``batch``
    spend-auth-shaped RedJubjub signatures (signed with ``rng``) on the host
    and on the device. Returns [(result, samples)] in that order."""
    from masp_tpu_torch.host.fields import JubjubFr
    from masp_tpu_torch.host.primitives import redjubjub as RJ
    from masp_tpu_torch.host.primitives.constants import spending_key_generator
    from masp_tpu_torch.host.rng import XorShiftRng
    from masp_tpu_torch.host.verifier import verify_proofs_batch
    from masp_tpu_torch.tools.bench import device_routes
    from masp_tpu_torch.tools.bench_tx import median, timed

    proofs = [proof] * batch
    inputs = [public_inputs] * batch
    out = []

    def check(name, fn):
        def accepted():
            if not fn():
                raise AssertionError(f"{name}: batch rejected")

        _, samples = timed(accepted, iters, clock)
        out.append(({
            "metric": f"batch-verify {name} (B={batch})",
            "value": round(median(samples) * 1000 / batch, 2),
            "unit": "ms/proof",
        }, samples))

    with device_routes(device):
        check("groth16 host-pairing", lambda: verify_proofs_batch(
            pvk, XorShiftRng.from_seed(b"\x01" * 16), proofs, inputs))
        if not skip_device_pairing:
            check("groth16 device-pairing", lambda: verify_proofs_batch(
                pvk, XorShiftRng.from_seed(b"\x02" * 16), proofs, inputs,
                use_device_pairing=True))

        # RedJubjub signature batch (spend-auth shaped)
        p_g = spending_key_generator()
        entries = []
        for i in range(batch):
            sk = RJ.PrivateKey(JubjubFr(3 + i))
            vk = RJ.PublicKey.from_private(sk, p_g)
            msg = bytes([i]) * 32
            entries.append(RJ.BatchEntry(vk=vk, msg=msg, sig=sk.sign(msg, rng, p_g)))
        check("redjubjub host", lambda: RJ.batch_verify(
            XorShiftRng.from_seed(b"\x03" * 16), entries, p_g, use_device=False))
        check("redjubjub device-msm", lambda: RJ.batch_verify(
            XorShiftRng.from_seed(b"\x04" * 16), entries, p_g, use_device=True))
    return out


def main(argv=None) -> int:
    from masp_tpu_torch import resolve_device
    from masp_tpu_torch.groth16.prover import create_proof_from_assembly, synthesize_witness
    from masp_tpu_torch.host.structures import prepare_verifying_key
    from masp_tpu_torch.tools.bench import device_arg, fixture_and_params
    from masp_tpu_torch.utils import benchlog

    argv = sys.argv[1:] if argv is None else argv
    dev = resolve_device(device_arg(argv))
    batch = int(os.environ.get("MASP_VERIFY_BATCH", "8"))
    iters = int(os.environ.get("MASP_VERIFY_ITERS", "3"))
    make_circuit, public_inputs, params, rng = fixture_and_params("output", dev)
    proof = create_proof_from_assembly(synthesize_witness(make_circuit()), params, 7, 9, device=dev)
    skip = os.environ.get("MASP_VERIFY_SKIP_DEVICE_PAIRING") == "1"
    for result, samples in measure(prepare_verifying_key(params.vk), proof, public_inputs, rng, batch, iters,
                                   dev, skip):
        benchlog.emit(result, samples, device=str(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
