#!/usr/bin/env python3
"""Times the tensor-core Montgomery product (kernels/mont_mul_mxu.py) of the
masp_tpu_torch package that Python imports, beside the integer product
mont_mul_fq on the same rows: the tool's question for the card, whether the
reductions on the tensor cores beat the integer product.

Both products run on ROWS reduced Fq rows (0, 1 and q - 1 first), each
launch inside a CUDA graph with inputs from HBM, after holding mont_mul_mxu
bit for bit against its plain version and mont_mul at ROWS and at 1,003
rows, and on rows that are not 16-byte aligned.

The script reaches the kernels through their public wrappers, so it times
another checkout's package just as well, for example a parent commit
unpacked with ``git archive``:

    python3 -m masp_tpu_torch.tools.bench_mxu                          # this checkout
    PYTHONPATH=<other checkout> python3 masp_tpu_torch/tools/bench_mxu.py

Prints the card's name and power limit, then one JSON line. Needs a card.
"""

from __future__ import annotations

import json
import random
import sys

import numpy as np
import torch

ROWS = 1 << 17
RAGGED = 1003
SEED = 20261018


def operands(n: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """(n, 24) Montgomery rows of seeded Fq values: 0, 1 and q - 1 first
    (as integers, so their raw limbs), 4,096 distinct rows tiled, b a
    permutation of a."""
    from masp_tpu_torch.ops import field as F

    q, rng = F.FQ.modulus, random.Random(SEED)
    vals = [0, 1, q - 1] + [rng.randrange(q) for _ in range(4093)]
    a = np.tile(F.encode(F.FQ, vals), (-(-n // len(vals)), 1))[:n]
    a[:3] = [[(v >> (16 * j)) & 0xFFFF for j in range(F.FQ.L)] for v in (0, 1, q - 1)]
    b = a[np.random.default_rng(SEED).permutation(n)]
    return (torch.as_tensor(a.astype(np.int32), device=dev), torch.as_tensor(b.astype(np.int32), device=dev))


def checked_times(mul, a, b) -> float:
    """mul held against the plain version and mont_mul at ROWS and RAGGED
    rows, and on RAGGED contiguous rows that start one int32 into their
    buffer (not 16-byte aligned), then its ms per launch."""
    from masp_tpu_torch.kernels import mont_mul as MK
    from masp_tpu_torch.kernels import mont_mul_mxu as MX
    from masp_tpu_torch.ops.field import FQ
    from masp_tpu_torch.tools.bench_jubjub import timed

    def unaligned(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        buf[1:] = x.reshape(-1)
        return buf[1:].view(x.shape)

    for what, p, q in (("", a, b), ("", a[:RAGGED], b[:RAGGED]),
                       (" (unaligned)", unaligned(a[:RAGGED]), unaligned(b[:RAGGED]))):
        got = mul(p, q)
        for name, want in (("plain", MX.mont_mul_mxu_plain(FQ, p, q)), ("mont_mul", MK.mont_mul(FQ, p, q))):
            if not torch.equal(got, want):
                raise AssertionError(f"mont_mul_mxu{what} differs from {name} at {p.shape[0]} rows")
    return timed(mul, (a, b), 3 * ROWS * 96, from_hbm=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_mxu: no CUDA device", file=sys.stderr)
        return 2
    import masp_tpu_torch
    from masp_tpu_torch.kernels import mont_mul as MK
    from masp_tpu_torch.kernels import mont_mul_mxu as MX
    from masp_tpu_torch.ops.field import FQ
    from masp_tpu_torch.tools.bench_jubjub import card, timed

    dev = torch.device("cuda")
    a, b = operands(ROWS, dev)
    res = {"rows": ROWS, "mont_mul_mxu_ms": checked_times(lambda p, q: MX.mont_mul_mxu(FQ, p, q), a, b),
           "mont_mul_fq_ms": timed(lambda p, q: MK.mont_mul(FQ, p, q), (a, b), 3 * ROWS * 96, from_hbm=True)}
    print(card())
    print(json.dumps({"package": masp_tpu_torch.__file__, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
