#!/usr/bin/env python3
"""Experiment: Montgomery multiplication with the reduction on the tensor
cores. The port of tools/exp_mxu_mont.py.

Of CIOS's multiply-adds, half multiply by fixed constants (m = T_lo N' mod R,
then m N): a product by a fixed bignum is a linear map over byte chunks, a
constant-matrix product over the batch, which the card's int8 tensor cores
(IMMA) compute exactly. ``kernels/mont_mul_mxu.mont_mul_mxu`` keeps the
schoolbook a b on the integer units and runs both reductions as MMAs.

This tool checks it bit for bit against the production ``mont_mul`` (and
host ints) on 256 random reduced Fq elements with 0, 1, N-1 and the
Montgomery 1 among them; the reference drops the top carry, so only inputs
below N are held to exactness. Then it times both as slopes over chains
x = f(x, b) at 2^17 rows of random limbs, k = 8 and 24 (``slope``: one CUDA
graph and eager launches on the card). A mismatch raises: the exit status is
non-zero.

    python3 -m masp_tpu_torch.tools.exp_mxu_mont                # on the card
    python3 -m masp_tpu_torch.tools.exp_mxu_mont --device cpu --rows 256
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from masp_tpu_torch import resolve_device
from masp_tpu_torch.kernels import mont_mul as MK
from masp_tpu_torch.kernels import mont_mul_mxu as MX
from masp_tpu_torch.ops.field import FQ
from masp_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints
from masp_tpu_torch.tools.bench_kernel_micro import slope, where

SEED = 11
EXACT_N = 256  # reduced elements held to exactness


def _operands(spec, n: int, rng) -> tuple[list[int], list[int]]:
    """n pairs of reduced elements: the edge pairs, then random ones."""
    N, one = spec.modulus, spec.R_mod
    edge = [(0, one), (1, N - 1), (N - 1, 1), (one, 0), (N - 1, N - 1), (one, one), (1, 1), (0, 0)]
    pairs = edge + [(int.from_bytes(rng.bytes(48), "little") % N, int.from_bytes(rng.bytes(48), "little") % N)
                    for _ in range(n - len(edge))]
    return [x for x, _ in pairs[:n]], [y for _, y in pairs[:n]]


def main(device="cuda", rows: int = 1 << 17, iters: int = 5, log=print) -> dict:
    """Exactness, then the production and mxu slopes; returns
    {"exact": True, "production": slope, "mxu": slope}."""
    dev = resolve_device(device)
    spec = FQ
    rng = np.random.default_rng(SEED)
    log(f"exp_mxu_mont on {where(dev)}")

    a_int, b_int = _operands(spec, EXACT_N, rng)
    a = torch.as_tensor(ints_to_limbs(a_int, spec.L).astype(np.int32), device=dev)
    b = torch.as_tensor(ints_to_limbs(b_int, spec.L).astype(np.int32), device=dev)
    got = MX.mont_mul_mxu(spec, a, b).cpu()
    want = MK.mont_mul(spec, a, b).cpu()
    rinv = pow(spec.R, -1, spec.modulus)
    host = [x * y * rinv % spec.modulus for x, y in zip(a_int, b_int)]
    eq = torch.equal(got, want) and limbs_to_ints(got.numpy()) == host
    log(f"mxu mont_mul exact vs production and host ints ({EXACT_N} reduced elements, edge values "
        f"included): {eq}")
    if not eq:
        bad = (got != want).any(dim=1).nonzero().flatten()[:5].tolist()
        raise AssertionError(f"mont_mul_mxu differs from mont_mul at lanes {bad}")

    # --- slope timing: chains over random 16-bit limbs ---
    a_big = torch.as_tensor(rng.integers(0, 1 << 16, (rows, spec.L)).astype(np.int32), device=dev)
    b_big = torch.as_tensor(rng.integers(0, 1 << 16, (rows, spec.L)).astype(np.int32), device=dev)

    def make_loop(mul):
        def make(k):
            def run():
                x = a_big
                for _ in range(k):
                    x = mul(spec, x, b_big)
                return x
            return run
        return make

    report = {"exact": eq}
    for name, mul in (("production", MK.mont_mul), ("mxu", MX.mont_mul_mxu)):
        report[name] = slope(f"Fq mont_mul {name} @{rows}", make_loop(mul), 8, 24, rows, dev, iters, log)
    mode = "graph" if dev.type == "cuda" else "eager"
    prod, mxu = report["production"][mode], report["mxu"][mode]
    ratio = f"{mxu / prod:.3f}x" if prod > 0 else "ratio n/a"
    log(f"mxu / production ({mode} slopes): {mxu:.4f} / {prod:.4f} ms per {rows} muls = {ratio} "
        f"on {where(dev)}")
    return report


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=1 << 17)
    args = ap.parse_args(argv)
    main(args.device, args.rows)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
