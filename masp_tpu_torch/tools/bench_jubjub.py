#!/usr/bin/env python3
"""Times the Jubjub add, the Pedersen fold and the Fr square-root kernels of
the masp_tpu_torch package that Python imports, and the parts of the Jubjub
path they pace.

- The kernels at the widths the Jubjub path launches them at, each launch
  inside a CUDA graph: the add on the 8 pairs of every addition case and on
  32 pairs with inputs in L2, and on 2^16 pairs from HBM; the fold over the
  Merkle hash's 172 chunks at 64, 1,024, 4,096 and 32,768 hashes (the table
  in L2, the digits from HBM from 4,096 hashes up); the square root at 2^12
  rows (from HBM) and at the widths the path launches it at (256 for a
  signature batch's R encodings, 4,102 for the decompressions). Each kernel
  is first held against its plain version at its narrowest width.
- The path, on the host clock, median of REPS runs: a FrozenCommitmentTree of
  2^16 seeded leaves (the whole build, and its device levels, 32,768 down to
  64 pairs, summed) and the batch verification of 256 RedJubjub signatures
  on the card. Beside the signatures' wall time, the main thread's CPU time
  of each run ("sigs_thread_cpu"), and the kernels' device time and count in
  one more run under torch.profiler ("sigs_device": the device time and
  count of its kernels and copies): what of the wall time the host's own
  work and the card take.
- Where the package's jubjub.cu takes MASP_JUBJUB_GROUP / MASP_JUBJUB_BLOCK
  (threads a pair, threads a block), the add and the fold built at each of
  SHAPES, each held against the plain versions, then timed as above at 8,
  32 and 2^16 pairs and 64 and 4,096 hashes.

The script reaches the kernels through their public wrappers (and the shapes
through the built library's C entries), so it times another checkout's
package just as well, for example a parent commit unpacked with
``git archive``:

    python3 -m masp_tpu_torch.tools.bench_jubjub                          # this checkout
    PYTHONPATH=<other checkout> python3 masp_tpu_torch/tools/bench_jubjub.py

Prints the card's name and power limit, then one JSON line: the package's
path, ms per launch by kernel and width, the path's seconds, and the shapes'
ms. Needs a card.
"""

from __future__ import annotations

import json
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

L2_BYTES = 50 * 2**20  # the H100 SXM's L2 cache
ROW_BYTES = 48 * 4  # a packed Jubjub point
ADD_WIDTHS = (8, 32, 1 << 16)
FOLD_WIDTHS = (64, 1024, 4096, 32768)
CHUNKS = 172
TREE_LEAVES = 1 << 16
SIGS = 256
REPS = 5
# (threads a pair, threads a block); jubjub.cu keeps the first
SHAPES = ((4, 128), (2, 128), (4, 64), (4, 256))
# the square root's rows: the check width, then the widths it is timed at
SQRT_CHECK = 256
SQRT_WIDTHS = (256, 4102, 1 << 12)
SEED = 20261018


def timed(fn, args, nbytes: int, from_hbm: bool) -> float:
    """ms per call of fn(*args), calls captured in one CUDA graph (median of
    5 replays); with ``from_hbm`` over enough copies of args (``nbytes`` a
    call) that each call reads its inputs from HBM."""
    from masp_tpu_torch.tools.bench_kernel_micro import graph_of, time_ms

    copies = -(-2 * L2_BYTES // nbytes) if from_hbm else 1
    sets = [args] + [tuple(a.clone() for a in args) for _ in range(copies - 1)]
    calls = max(20, copies)
    outs = [None] * copies  # each copy's output stays alive: distinct buffers

    def run():
        for i in range(calls):
            outs[i % copies] = fn(*sets[i % copies])

    return time_ms(graph_of(run), torch.device("cuda"), 5)[0] / calls


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def _equal(what: str, got, want) -> None:
    if not torch.equal(got, want):
        raise AssertionError(f"{what} differs from its plain version")


def kernel_times(add, fold, inputs, add_widths=ADD_WIDTHS, fold_widths=FOLD_WIDTHS) -> dict:
    """add and fold (the wrappers, or another build's entries) held against
    the plain versions, then ms per launch at each width."""
    from masp_tpu_torch.kernels import jubjub as KJ

    P8, Q8, P, Q, table, idx = inputs
    pairs = torch.cat([P, Q], dim=1)
    _equal("jubjub_add (all cases)", add(P8, Q8), KJ.jubjub_add_plain(P8, Q8))
    for w in add_widths[1:]:
        want = KJ.jubjub_add_plain(P[:w], Q[:w])
        _equal(f"jubjub_add (width {w})", add(P[:w], Q[:w]), want)
        _equal(f"jubjub_add (width {w}, strided)", add(pairs[:w, :48], pairs[:w, 48:]), want)
    narrow = idx[:, : fold_widths[0]].contiguous()
    _equal("pedersen_fold", fold(table, narrow), KJ.pedersen_fold_plain(table, narrow))
    res = {"jubjub_add": {}, "pedersen_fold": {}}
    for w in add_widths:
        args = (P8, Q8) if w == 8 else (P[:w], Q[:w])
        res["jubjub_add"][w] = timed(add, args, 3 * w * ROW_BYTES, from_hbm=w >= 1 << 16)
    for w in fold_widths:
        sub = idx[:, :w].contiguous()
        res["pedersen_fold"][w] = timed(lambda i: fold(table, i), (sub,), CHUNKS * w * 4 + w * ROW_BYTES,
                                        from_hbm=w >= 4096)
    return res


def sqrt_times(sqrt, a) -> dict:
    """sqrt held against the plain version on the first SQRT_CHECK rows of
    a, then ms per launch at each
    of SQRT_WIDTHS rows, inputs from HBM from 4,096 rows up (below, 34-540 KB
    in L2: the kernel reads each row once, the time is the products')."""
    from masp_tpu_torch.kernels import jubjub as KJ

    root, ok = sqrt(a[:SQRT_CHECK])
    want_root, want_ok = KJ.fr_sqrt_plain(a[:SQRT_CHECK])
    _equal("fr_sqrt", root, want_root)
    _equal("fr_sqrt (flags)", ok, want_ok)
    return {w: timed(sqrt, (a[:w].contiguous(),), w * (2 * 16 + 1) * 4, from_hbm=w >= 4096) for w in SQRT_WIDTHS}


def path_times(rng) -> dict:
    """Seconds, median of REPS runs: the 2^16-leaf tree, its device levels
    summed, and batch_verify of SIGS signatures on the card (true), with the
    main thread's CPU seconds of each signature run; after one warm-up run of
    each. Then one more signature run under torch.profiler: the device ms and
    count of its kernels and copies."""
    from masp_tpu_torch.host.fields import SCALAR_MODULUS, JubjubFr
    from masp_tpu_torch.host.primitives import redjubjub as RJ
    from masp_tpu_torch.host.primitives.constants import spending_key_generator
    from masp_tpu_torch.host.primitives.merkle_tree import FrozenCommitmentTree
    from masp_tpu_torch.host.primitives.sapling import Node
    from masp_tpu_torch.host.rng import XorShiftRng
    from masp_tpu_torch.ops import pedersen as PED

    keys = random.Random(int(rng.integers(1 << 30)))
    leaves = [Node(keys.randrange(SCALAR_MODULUS).to_bytes(32, "little")) for _ in range(TREE_LEAVES)]
    g, q = spending_key_generator(), JubjubFr.META.modulus

    class _Bytes:
        def fill_bytes(self, k):
            return keys.randbytes(k)

    entries = []
    for i in range(SIGS):
        sk = RJ.PrivateKey(JubjubFr(keys.randrange(1, q)))
        msg = f"bench-jubjub-{i}".encode()
        entries.append(RJ.BatchEntry(vk=RJ.PublicKey.from_private(sk, g), msg=msg, sig=sk.sign(msg, _Bytes(), g)))

    twin, levels = PED.batch_merkle_hash, []

    def level(*args, **kwargs):
        t0 = time.perf_counter()
        out = twin(*args, **kwargs)
        levels[-1] += time.perf_counter() - t0
        return out

    tree, device, sigs = [], [], []
    PED.batch_merkle_hash = level
    try:
        for _ in range(REPS + 1):
            levels.append(0.0)
            t0 = time.perf_counter()
            FrozenCommitmentTree.new(leaves)
            tree.append(time.perf_counter() - t0)
            device.append(levels[-1])
    finally:
        PED.batch_merkle_hash = twin
    def verify():
        if not RJ.batch_verify(XorShiftRng.from_seed(bytes(range(16))), entries, g, use_device=True):
            raise AssertionError("batch_verify rejected valid signatures")

    cpu = []
    for _ in range(REPS + 1):
        t0, c0 = time.perf_counter(), time.thread_time()
        verify()
        sigs.append(time.perf_counter() - t0)
        cpu.append(time.thread_time() - c0)
    res = {name: {"median": statistics.median(v[1:]), "runs": v[1:]}
           for name, v in (("tree", tree), ("tree_device_levels", device), ("sigs", sigs), ("sigs_thread_cpu", cpu))}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        verify()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]  # kernels and copies
    res["sigs_device"] = {"ms": sum(e.time_range.elapsed_us() for e in ops) / 1e3, "ops": len(ops)}
    return res


def shape_defines(group: int, block: int) -> tuple[str, ...]:
    return (f"MASP_JUBJUB_GROUP={group}", f"MASP_JUBJUB_BLOCK={block}")


def built_with(group: int, block: int):
    """The add and the fold of jubjub.cu built at (group, block), called
    through that library's C entries (the wrappers' argument types); a
    measurement's build, so its launches are not counted."""
    from masp_tpu_torch.kernels import build
    from masp_tpu_torch.kernels import jubjub as KJ

    lib = build.library("jubjub", shape_defines(group, block))
    add_fn, fold_fn = lib.masp_jubjub_add, lib.masp_pedersen_fold
    for fn, name in ((add_fn, "jubjub_add"), (fold_fn, "pedersen_fold")):
        fn.argtypes, fn.restype = KJ._c_fn(name).argtypes, KJ._c_fn(name).restype

    def check(err):
        if err != 0:
            raise RuntimeError(f"jubjub.cu at ({group}, {block}): CUDA error {err}")

    def add(p, q):
        out = torch.empty((p.shape[0], 48), dtype=torch.int32, device=p.device)
        check(add_fn(p.data_ptr(), p.stride(0), q.data_ptr(), q.stride(0), out.data_ptr(), p.shape[0],
                     KJ.constant("d", p.device).data_ptr(), torch.cuda.current_stream().cuda_stream))
        return out

    def fold(table, idx):
        out = torch.empty((idx.shape[1], 48), dtype=torch.int32, device=idx.device)
        check(fold_fn(KJ.fold_table(table).data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], idx.shape[1],
                      torch.cuda.current_stream().cuda_stream))
        return out

    return add, fold


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_jubjub: no CUDA device", file=sys.stderr)
        return 2
    import masp_tpu_torch
    from masp_tpu_torch.host.fields import SCALAR_MODULUS, JubjubFr, Scalar
    from masp_tpu_torch.host.jubjub import ExtendedPoint
    from masp_tpu_torch.host.primitives.constants import spending_key_generator
    from masp_tpu_torch.kernels import build
    from masp_tpu_torch.kernels import jubjub as KJ
    from masp_tpu_torch.ops import field as F
    from masp_tpu_torch.ops import jubjub as J
    from masp_tpu_torch.ops import pedersen as PED

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    g = spending_key_generator()
    p = g * JubjubFr(int(rng.integers(1, 1 << 62)))
    chain = []
    for _ in range(1024):
        chain.append(p)
        p = p + g
    O, t = ExtendedPoint.identity(), ExtendedPoint.from_affine(Scalar(0), Scalar(SCALAR_MODULUS - 1))

    def rows(points):
        return torch.as_tensor(np.concatenate(J.encode_points(points), axis=1).astype(np.int32), device=dev)

    # every addition case: generic pairs, P + P, P + (-P), O + P, the order-2 point twice
    P8 = rows(chain[:4] + [chain[0], chain[1], O, t])
    Q8 = rows(chain[4:8] + [chain[0], -chain[1], chain[2], t])
    n = max(ADD_WIDTHS)
    base = rows(chain).repeat(n // len(chain) + 1, 1)
    P = KJ.jubjub_add_plain(base[:n], base[3 : n + 3])  # sums: general Z
    Q = base[1 : n + 1].contiguous()
    table = PED._chunk_tables(CHUNKS, dev)
    idx = torch.as_tensor(rng.integers(0, 9, (CHUNKS, max(FOLD_WIDTHS)), dtype=np.int32), device=dev)
    inputs = (P8, Q8, P, Q, table, idx)
    draw = random.Random(SEED)
    vals = [0, 1, SCALAR_MODULUS - 1] + [draw.randrange(SCALAR_MODULUS) for _ in range(max(SQRT_WIDTHS) - 3)]
    sqrt_rows = torch.as_tensor(F.encode(F.FR, vals).astype(np.int32), device=dev)

    res = kernel_times(KJ.jubjub_add, KJ.pedersen_fold, inputs)
    res["fr_sqrt"] = sqrt_times(KJ.fr_sqrt, sqrt_rows)
    res["path_s"] = path_times(rng)
    if "MASP_JUBJUB_GROUP" in (build.CSRC / "jubjub.cu").read_text():
        build.build_all([("jubjub", shape_defines(grp, blk)) for grp, blk in SHAPES])  # one nvcc each, in parallel
        res["shapes"] = {f"{grp}, {blk}": kernel_times(*built_with(grp, blk), inputs, (8, 32, n), (64, 4096))
                         for grp, blk in SHAPES}
    print(card())
    print(json.dumps({"package": masp_tpu_torch.__file__, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
