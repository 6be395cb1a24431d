#!/usr/bin/env python3
"""Kernel microbenchmarks of the port: the port of tools/bench_kernel_micro.py.

Every per-op time is a SLOPE: the same program with k1 and k2 repetitions,
per-rep time = (t(k2) - t(k1)) / (k2 - k1), each t the median of 5
(``slope``). On the card each program is timed with CUDA events twice:
captured into one CUDA graph and replayed, the counterpart of the JAX tool's
fori_loop inside one jitted program, which gives the card's time per rep
with the launch cost taken out; and issued eagerly from Python, launch cost
included. Where a rep is a launch, their difference is the host cost of one
launch. Sections:

  1. one G1 complete-add level, 2^16 adds over 2^17 packed rows
     (``point_add`` on the even and odd row views), k = 2 and 6;
  2. the Fq ``mont_mul`` chain x = mont_mul(x, b) at 2^17 rows, k = 8, 24;
  3. ``int8_dot`` exactness against numpy at (1024, 48) @ (48, 96);
  4. ``int8_dot_loop`` at that shape, k = 8 and 64 products in one launch
     (and k = 4096 and 32768, which the card's event timer resolves), each
     k's result checked against k x numpy (wrapping as int32);
  5. the sorted MSM of 2^17 copies of one point (``sorted_msm_from_limbs``,
     unsigned digits) for c in {8, 10, 12, 13}, checked against the host.
     Each c runs the batch-affine ladder, as the JAX tool does on its
     accelerator, where the window count allows: c = 10, 12 and 13 give 26,
     22 and 20 windows, which that ladder cannot take; those run the scan
     ladder, named on their line.

A wrong result or a failed launch raises: the exit status is non-zero.

    python3 -m masp_tpu_torch.tools.bench_kernel_micro         # on the card
    python3 -m masp_tpu_torch.tools.bench_kernel_micro --device cpu --rows 256 --points 64 --c 4 6
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from masp_tpu_torch import resolve_device
from masp_tpu_torch.host.bls12_381 import G1, R
from masp_tpu_torch.kernels import int8_dot as I8
from masp_tpu_torch.kernels import mont_mul as MK
from masp_tpu_torch.kernels import point_add as PA
from masp_tpu_torch.ops import msm_sorted as MS
from masp_tpu_torch.ops import weierstrass as W
from masp_tpu_torch.ops.field import FQ
from masp_tpu_torch.ops.limbs import limbs_to_ints

SEED = 7
DOT_SHAPE = (1024, 48, 96)  # the Montgomery reduction's shape: (8 * 128, 48) @ (48, 96)
# CUDA events resolve about 0.5 us: a difference t(k2) - t(k1) below this
# gives no rate
RESOLVED_MS = 0.002


def where(device) -> str:
    """What a time was taken on, for every printed line."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "the CPU (plain versions; not a device time)"


def time_ms(fn, device, iters: int):
    """(median ms of fn() over ``iters`` runs, median host ms to issue it,
    the last result). On the card: CUDA events around each run after one
    warm-up run, and the host clock from the call until it returns (before
    the synchronisation), which is the time to enqueue its launches. On the
    CPU both are the host clock."""
    if device.type != "cuda":
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times)), float(np.median(times)), out
    out = fn()
    torch.cuda.synchronize(device)
    times, host = [], []
    for _ in range(iters):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        out = fn()
        host.append(1e3 * (time.perf_counter() - t0))
        e1.record()
        torch.cuda.synchronize(device)
        times.append(e0.elapsed_time(e1))
    return float(np.median(times)), float(np.median(host)), out


def graph_of(fn):
    """fn captured into one CUDA graph, after a warm-up run on a side stream
    as capture asks; returns the graph's replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def per_rep(ms: float) -> str:
    """A time a rep, in three significant digits and a unit that reads."""
    us = 1e3 * ms
    if abs(us) < 1:
        return f"{1e3 * us:.3g} ns"
    return f"{us:.3g} us" if abs(us) < 1e3 else f"{ms:.3g} ms"


def slope(name, make_fn, k1: int, k2: int, unit_ops: int, device, iters: int = 5, log=print,
          keep_out: bool = False) -> dict:
    """Per-rep ms from two repetition counts of one program, (t(k2) -
    t(k1)) / (k2 - k1) over medians of ``iters``; make_fn(k) returns the
    program with k reps. On the card as one CUDA graph ("graph") and
    eagerly ("eager"), with "launch_ms" = eager - graph per rep and
    "enqueue_ms" = the host's time per rep to issue the eager program; on
    the CPU eagerly only. "<mode>_const" is each mode's constant, t(k1)
    less k1 reps. With ``keep_out``, "out" holds the last eager run's
    result at k1 and k2."""
    modes = {"eager": make_fn}
    if device.type == "cuda":
        modes = {"graph": lambda k: graph_of(make_fn(k)), "eager": make_fn}
    res = {}
    for mode, build in modes.items():
        t1, h1, out1 = time_ms(build(k1), device, iters)
        t2, h2, out2 = time_ms(build(k2), device, iters)
        per = (t2 - t1) / (k2 - k1)
        res[mode], res[f"{mode}_const"] = per, max(t1 - per * k1, 0)
        if mode == "eager" and keep_out:
            res["out"] = {k1: out1, k2: out2}
        if mode == "eager" and device.type == "cuda":
            res["enqueue_ms"] = (h2 - h1) / (k2 - k1)
        if t2 - t1 < RESOLVED_MS:
            rate = f"rate not resolved (t(k2) - t(k1) below {RESOLVED_MS} ms)"
        else:
            rate = f"{unit_ops / per / 1e3:.2f} M ops/s"
        log(f"{name} [{mode}]: xK={k1} {t1:.4f} ms, xK={k2} {t2:.4f} ms -> {per_rep(per)} per rep; {rate} "
            f"(constant ~{res[f'{mode}_const']:.4f} ms; median of {iters}) on {where(device)}")
    if "graph" in res:
        res["launch_ms"] = res["eager"] - res["graph"]
        log(f"{name}: eager - graph = {per_rep(res['launch_ms'])} per rep; the host takes "
            f"{per_rep(res['enqueue_ms'])} per rep to issue it eagerly, on {where(device)}")
    return res


def _g1_rows(p, n: int, device):
    """(n, 72) int32 packed projective rows [X | Y | Z] of n copies of p."""
    cols = [np.tile(c.astype(np.int32), (n, 1)) for c in W.encode_g1_points([p])]
    return torch.as_tensor(np.concatenate(cols, axis=1), device=device)


def _g1_point(row) -> G1:
    r = row.cpu().numpy().reshape(3, 1, FQ.L)
    return W.decode_g1_points(r[0], r[1], r[2])[0]


def main(device="cuda", rows: int = 1 << 17, points: int = 1 << 17, cs=(8, 10, 12, 13),
         iters: int = 5, msm_iters: int = 3, log=print) -> dict:
    """Run the five sections; returns their numbers, and per c the MSM's
    ladder, time and result row."""
    dev = resolve_device(device)
    log(f"bench_kernel_micro on {where(dev)}: {rows} rows, {points} MSM points")
    rng = np.random.default_rng(SEED)
    report = {}
    p = G1.generator() * 987654321

    # --- 1. one full-width G1 add level (rows / 2 adds), slope over k levels --------
    pk = _g1_rows(p, rows, dev)
    pairs = pk.reshape(-1, 2 * pk.shape[1])
    left, right = pairs[:, : pk.shape[1]], pairs[:, pk.shape[1] :]

    def make_level(k):
        def run():
            for _ in range(k):
                PA.point_add(1, left, right)
        return run

    report["g1_add"] = slope(f"G1 add level ({rows // 2} adds)", make_level, 2, 6, rows // 2, dev, iters, log)

    # --- 2. the Fq mont_mul chain ----------------------------------------------------
    a = torch.as_tensor(rng.integers(0, 1 << 16, (rows, FQ.L)).astype(np.int32), device=dev)
    b = torch.as_tensor(rng.integers(0, 1 << 16, (rows, FQ.L)).astype(np.int32), device=dev)

    def make_mul(k):
        def run():
            x = a
            for _ in range(k):
                x = MK.mont_mul(FQ, x, b)
            return x
        return run

    report["mont_mul_fq"] = slope(f"Fq mont_mul chain @{rows}", make_mul, 8, 24, rows, dev, iters, log)

    # --- 3. int8 dot: exactness ------------------------------------------------------
    M_, K_, N_ = DOT_SHAPE
    x8n = rng.integers(0, 127, (M_, K_), dtype=np.int8)
    w8n = rng.integers(0, 127, (K_, N_), dtype=np.int8)
    x8, w8 = torch.as_tensor(x8n, device=dev), torch.as_tensor(w8n, device=dev)
    want = x8n.astype(np.int32) @ w8n.astype(np.int32)
    if not np.array_equal(I8.int8_dot(x8, w8).cpu().numpy(), want):
        raise AssertionError(f"int8_dot: WRONG RESULT against numpy at {DOT_SHAPE}")
    log(f"int8 dot ({M_},{K_})@({K_},{N_}): OK (exact against numpy) on {where(dev)}")

    # --- 4. int8 product throughput inside one launch --------------------------------
    # the JAX tool's k = 8 and 64; on the card 56 more products take less
    # than the event timer resolves, so k = 4096 and 32768 give the rate
    def make_mm(k):
        return lambda: I8.int8_dot_loop(x8, w8, k)

    macs = M_ * K_ * N_
    for k1, k2 in ((8, 64), (4096, 32768)):
        res = slope(f"int8 ({M_},{K_})@({K_},{N_}) in-kernel", make_mm, k1, k2, macs, dev, iters, log,
                    keep_out=True)
        report.setdefault("int8_dot_loop", {})[(k1, k2)] = res
        for k, got in res.pop("out").items():  # the timed runs' own results: no launch more
            if not np.array_equal(got.cpu().numpy(), (k * want.astype(np.int64)).astype(np.int32)):
                raise AssertionError(f"int8_dot_loop: WRONG RESULT, the sum of {k} products differs from {k} x numpy")
        per = res["graph" if dev.type == "cuda" else "eager"]
        if per * (k2 - k1) >= RESOLVED_MS:
            log(f"  == {macs / per / 1e6:.1f} G MACs/s at the reduction shape (k = {k1}, {k2}) on {where(dev)}")
    if not np.array_equal(I8.int8_dot_loop(x8, w8, 64).cpu().numpy(), 64 * want):
        raise AssertionError("int8_dot_loop: WRONG RESULT, the sum of 64 products differs from 64 x numpy")
    log(f"int8_dot_loop: exact against k x numpy (int32 wrap) at every k timed on {where(dev)}")

    # --- 5. sorted MSM c sweep -------------------------------------------------------
    scal = rng.integers(0, 1 << 16, (points, 16), dtype=np.uint16)
    limbs = torch.as_tensor(scal.astype(np.int32), device=dev)
    mpk = pk if points == rows else _g1_rows(p, points, dev)
    want_pt = p * (sum(limbs_to_ints(scal)) % R)
    report["msm"] = {}
    for c in cs:
        n_windows = MS.n_windows_for(c)
        affine = MS.affine_ladder_takes(n_windows, points)
        ladder = "affine" if affine else "scan"
        default, MS.AFFINE_LADDER = MS.AFFINE_LADDER, affine
        try:
            ms, _, out = time_ms(lambda c=c: MS.sorted_msm_from_limbs(W.G1Ops, mpk, limbs, c, signed=False),
                                 dev, msm_iters)
        finally:
            MS.AFFINE_LADDER = default
        if _g1_point(out) != want_pt:
            raise AssertionError(f"sorted MSM c={c} ({ladder} ladder) differs from the host MSM")
        report["msm"][c] = {"ladder": ladder, "windows": n_windows, "ms": ms, "row": out.cpu().numpy()}
        log(f"sorted MSM {points} points c={c} ({n_windows} windows, {ladder} ladder): median {ms:.3f} ms "
            f"(of {msm_iters}), equals the host MSM, on {where(dev)}")
    log("done")
    return report


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=1 << 17)
    ap.add_argument("--points", type=int, default=1 << 17)
    ap.add_argument("--c", type=int, nargs="+", default=[8, 10, 12, 13])
    args = ap.parse_args(argv)
    main(args.device, args.rows, args.points, tuple(args.c))
    return 0


if __name__ == "__main__":
    sys.exit(cli())
