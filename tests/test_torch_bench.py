"""The port's measurement surface against the JAX package's, on the CPU at
tiny sizes: the tracer's span tree (masp_tpu_torch/utils/tracing.py against
masp_tpu/utils/tracing.py and tests/test_tracing.py), the bench log
(utils/benchlog.py), the twin of bench.py's worker
(masp_tpu_torch/tools/bench.py: its metric names, and its measuring loop with
a fake clock, whose samples must be the clock's own window deltas), and the
twins of tools/bench_{batch,tx,mixed_batch,verify}.py. The proving's device
halves are stubbed by the host reference prover (a tiny proof through the
plain kernels takes about 9 s on the CPU; tests/test_torch_batch.py and
tests/test_torch_prover.py hold the device prover against host_proof), the
bundle's proving as tests/test_torch_transaction.py stubs it, and the device
pairing by a recorder that answers with the host pairing."""

import json
from pathlib import Path

import pytest

import bench as JBENCH
from masp_tpu.groth16 import reference as REF
from masp_tpu.utils import benchlog as JBL
from masp_tpu.utils import tracing as JT
from masp_tpu_torch.groth16 import prover as TP
from masp_tpu_torch.groth16 import reference as TREF
from masp_tpu_torch.groth16 import sapling_prover as SP
from masp_tpu_torch.groth16.local_prover import LocalTxProver
from masp_tpu_torch.host import structures as HS
from masp_tpu_torch.host.bls12_381 import G1, G2, pairing_product_is_one
from masp_tpu_torch.host.primitives import redjubjub as RJ
from masp_tpu_torch.host.rng import XorShiftRng, random_scalar
from masp_tpu_torch.ops import jubjub as TJ
from masp_tpu_torch.ops import pairing as TPAIR
from masp_tpu_torch.tools import bench as TBENCH
from masp_tpu_torch.tools import bench_batch, bench_mixed_batch, bench_tx, bench_verify
from masp_tpu_torch.utils import benchlog as TBL
from masp_tpu_torch.utils import tracing as TT
from tests import test_tracing
from tests.test_torch_batch import _stub_proving
from tests.test_torch_card import _Bits
from tests.test_torch_prover import (  # noqa: F401 (_one_torch_thread: autouse fixture)
    BitsCircuit, _host_params, _one_torch_thread, _port_params, _witness,
)

REPO = Path(__file__).resolve().parent.parent
BITS = [1, 0, 1, 1, 0, 1]


def _span_program(t):
    """Nested spans, repeated names, and one name at two depths."""
    for _ in range(2):
        with t.span("prove"):
            with t.span("setup"):
                pass
            for q in ("h", "l"):
                with t.span(f"msm/{q}"):
                    with t.span("add"):
                        pass
            with t.span("fetch"):
                pass
    with t.span("msm/h"):
        pass


def _set_totals(port, ref):
    """Give each node of both trees the same total (its pre-order index
    times 1.25 s) so that their reports can be compared as text."""
    def walk(a, b, k):
        for (na, ca), (nb, cb) in zip(a.children.items(), b.children.items()):
            assert na == nb
            k += 1
            ca.total = cb.total = 1.25 * k
            k = walk(ca, cb, k)
        return k

    walk(port.root, ref.root, 0)


def test_tracer_is_the_reference_tree(monkeypatch):
    """tests/test_tracing.py's four cases pass against the port's tracer;
    on one span program its rows equal the reference's in (depth, name,
    count), each row's self time is its total minus its children's within
    1e-9, and with equal totals its report() is the reference's table;
    stats() sums a name over every depth; Tracer() is enabled by default."""
    monkeypatch.setattr(test_tracing, "tracing", TT)
    monkeypatch.setattr(test_tracing, "Tracer", TT.Tracer)
    monkeypatch.setattr(test_tracing, "device_profile", TT.device_profile)
    for case in (test_tracing.test_spans_nest_and_accumulate, test_tracing.test_disabled_tracer_records_nothing,
                 test_tracing.test_module_tracer_reset_and_enable, test_tracing.test_device_profile_noop_without_dir):
        case()
    assert TT.Tracer().enabled and JT.Tracer().enabled

    port, ref = TT.Tracer(), JT.Tracer()
    _span_program(port)
    _span_program(ref)
    rows = port.rows()
    assert [r[:2] + r[3:4] for r in rows] == [r[:2] + r[3:4] for r in ref.rows()]
    assert [(d, n) for d, n, *_ in rows][:4] == [(0, "prove"), (1, "setup"), (1, "msm/h"), (2, "add")]
    for i, (depth, _, total, _, self_s) in enumerate(rows):
        children = []
        for d, _, t, _, _ in rows[i + 1:]:
            if d <= depth:
                break
            if d == depth + 1:
                children.append(t)
        assert abs(self_s - (total - sum(children))) < 1e-9
    stats = port.stats()
    assert stats["msm/h"]["count"] == 3 and len(stats["msm/h"]["host_each_s"]) == 3
    assert stats["msm/h"]["host_s"] == pytest.approx(sum(stats["msm/h"]["host_each_s"]))
    assert stats["add"]["count"] == 4 and stats["prove"]["device_ms"] is None
    _set_totals(port, ref)
    assert port.report() == ref.report()
    assert port.report().splitlines()[0].split() == ["span", "total", "calls", "self"]


def test_benchlog_matches_reference(tmp_path, monkeypatch, capsys):
    """emit() of both packages prints the same line and appends the same
    entry apart from ts and backend (the port's names the card, "cpu" here);
    with a file where the log's directory should be, neither raises and
    both still print the line. The port's log is its own, and gitignored."""
    result = {"metric": "spend-circuit Groth16 proofs/sec/chip", "value": 2.5, "unit": "proofs/s"}
    printed, entries = {}, {}
    for name, mod in (("jax", JBL), ("port", TBL)):
        path = tmp_path / name / "bench_log.jsonl"
        monkeypatch.setattr(mod, "BENCH_LOG", str(path))
        mod.emit(result, [0.1234567, 2], circuit="spend", batch=0)
        printed[name] = capsys.readouterr().out
        (entries[name],) = [json.loads(line) for line in path.read_text().splitlines()]
        assert entries[name].pop("ts").endswith("Z")
    assert printed["jax"] == printed["port"] == json.dumps(result) + "\n"
    assert entries["port"].pop("backend") == "cpu"
    entries["jax"].pop("backend", None)
    assert entries["jax"] == entries["port"] == {**result, "samples_s": [0.12346, 2.0], "circuit": "spend",
                                                  "batch": 0}
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    for mod in (JBL, TBL):
        monkeypatch.setattr(mod, "BENCH_LOG", str(blocker / "bench_log.jsonl"))
        mod.emit(result)
        out = capsys.readouterr()
        assert out.out == json.dumps(result) + "\n" and "could not append" in out.err
    monkeypatch.undo()
    rel = Path(TBL.BENCH_LOG).relative_to(REPO).as_posix()
    assert rel != "benches/bench_log.jsonl"
    assert rel.rsplit("/", 1)[0] + "/" in (REPO / ".gitignore").read_text().split()


class _Clock:
    """A fake clock with uneven steps; each reading notes how many proofs
    the prover had drained by then."""

    def __init__(self, drained):
        self.t, self.k, self.drained, self.readings = 0.0, 0, drained, []

    def __call__(self):
        self.k += 1
        self.t += 0.25 * self.k * self.k
        self.readings.append((self.t, len(self.drained)))
        return self.t


def _host_proving(monkeypatch):
    """The prover's device halves replaced by the port's host reference
    prover; returns the (r, s, proof) of every proof drained."""
    drained = []
    monkeypatch.setattr(TP, "_enqueue", lambda asm, params, r, s, device, mesh=None: (asm, params, r, s))

    def drain(pending):
        asm, params, r, s = pending
        drained.append((r, s, TREF.host_proof(asm, params, r, s)))
        return drained[-1][2]

    monkeypatch.setattr(TP, "_drain", drain)
    return drained


def test_bench_twin_names_and_measured_samples(monkeypatch):
    """The twin's metric names are bench.py's for every circuit and batch;
    its measuring loop in single, batch and stream modes: every sample is
    the fake clock's own delta over one window (over B in the batch modes),
    never a share of one total; in stream mode the edges are read as the
    batch prover pulls each window's first witness, after it has drained all
    but the last W proofs before it; median_s, min_s, max_s, iters, value
    and vs_baseline follow bench.py:283-299; every proof, with bench.py's
    (r, s), equals the JAX package's host_proof and the last verifies."""
    for kind in ("spend", "output", "convert"):
        for batch in ("0", "1", "2", "8"):
            monkeypatch.setenv("MASP_BENCH_CIRCUIT", kind)
            monkeypatch.setenv("MASP_BENCH_BATCH", batch)
            assert TBENCH._metric_name() == JBENCH._metric_name()
    monkeypatch.delenv("MASP_BENCH_CIRCUIT")
    monkeypatch.delenv("MASP_BENCH_BATCH")
    monkeypatch.delenv("MASP_TRACE", raising=False)
    monkeypatch.delenv("MASP_PROFILE", raising=False)
    window = 2
    monkeypatch.setenv("MASP_BATCH_WINDOW", str(window))
    params, _ = _host_params(BitsCircuit())
    cs, _ = _witness(BitsCircuit(BITS))
    v = sum(b << i for i, b in enumerate(BITS))
    public = [v * v + (BITS[0] ^ BITS[1])]
    drained = _host_proving(monkeypatch)
    want_proof = {}

    for mode, iters, batch in (("single", 3, 0), ("batch", 2, 2), ("stream", 3, 2)):
        drained.clear()
        clock = _Clock(drained)
        result, raw = TBENCH.measure(lambda: _Bits(BITS), _port_params(params), public, iters, batch,
                                     mode == "stream", "cpu", clock)
        t = [x for x, _ in clock.readings]
        if mode == "single":
            assert raw == [t[1] - t[0], t[3] - t[2], t[5] - t[4]]
            rs = [(100 + i, 200 + i) for i in range(iters)]
        elif mode == "batch":
            assert raw == [(t[1] - t[0]) / 2, (t[3] - t[2]) / 2]
            rs = [(100 + i + j, 200 + i + j) for i in range(iters) for j in range(batch)]
        else:
            assert len(t) == iters + 1
            assert raw == [(b - a) / batch for a, b in zip(t, t[1:])]
            # the warm-up, then all but the last W proofs before each edge
            assert [n for _, n in clock.readings] == [1 + max(0, k * batch - window) for k in range(iters)] + [
                1 + iters * batch]
            rs = [(100 + j, 200 + j) for j in range(iters * batch)]
        assert len(set(raw)) == len(raw) == iters
        assert [(r, s) for r, s, _ in drained] == [(11, 22)] + rs
        for r, s, proof in drained:
            if (r, s) not in want_proof:
                want_proof[r, s] = REF.host_proof(cs, params, r, s).write()
            assert proof.write() == want_proof[r, s]
        ordered = sorted(raw)
        median = ordered[iters // 2] if iters % 2 else (ordered[iters // 2 - 1] + ordered[iters // 2]) / 2
        assert result == {
            "metric": "spend-circuit Groth16 proofs/sec/chip" + (f" (batch {batch})" if batch > 1 else ""),
            "value": round(1 / median, 4), "unit": "proofs/s", "vs_baseline": round(2.0 / median, 3),
            "median_s": round(median, 4), "min_s": round(ordered[0], 4), "max_s": round(ordered[-1], 4),
            "iters": iters, "sampled": TBENCH.SAMPLED[mode]}


def test_bench_tools_print_the_source_metrics(monkeypatch, tmp_path, capsys):
    """The four tools' measuring functions at small sizes on the CPU:
    bench_batch on the tiny circuit (device halves by the host prover),
    bench_tx and bench_mixed_batch (1 Spend, 1 Convert, 3 Outputs) with the
    bundle's proving stubbed, bench_verify at B = 2 with the device pairing
    and the RedJubjub device batch recorders that answer with the host
    routes (tests/test_torch_jubjub.py holds the device batch's CPU route),
    each reached with the device asked for; each result carries the source's metric string and unit, and
    benchlog prints it. Every entry point raises without a card."""
    monkeypatch.setattr(TBL, "BENCH_LOG", str(tmp_path / "bench_log.jsonl"))
    params, _ = _host_params(BitsCircuit())
    tparams = _port_params(params)
    v = sum(b << i for i, b in enumerate(BITS))
    public = [v * v + (BITS[0] ^ BITS[1])]
    drained = _host_proving(monkeypatch)
    got = bench_batch.measure(lambda: _Bits(BITS), tparams, public, 2, "output", "cpu")
    assert capsys.readouterr().out.startswith("output B=2: serial ")
    assert got["metric"] == "output batch proving (B=2), witness synthesis included" and got["unit"] == "s/proof"
    assert len(drained) == 7

    results = []
    proof = drained[0][2]
    recorded = []

    def pairing_recorder(pairs, device="cuda"):
        recorded.append(("pairing", str(device)))
        return pairing_product_is_one(pairs)

    def sigs_recorder(rng, batch, p_g, device="cuda"):
        recorded.append(("sigs", str(device)))
        return RJ.batch_verify(rng, batch, p_g, use_device=False)

    monkeypatch.setattr(TPAIR, "pairing_product_is_one_device", pairing_recorder)
    monkeypatch.setattr(TJ, "batch_verify_device", sigs_recorder)
    results += bench_verify.measure(HS.prepare_verifying_key(tparams.vk), proof, public,
                                    XorShiftRng.from_seed(bytes(range(16))), 2, 1, "cpu")
    assert recorded == [("pairing", "cpu")] * 2 + [("sigs", "cpu")] * 2

    _stub_proving(monkeypatch, TP, SP, HS.Proof, G1.generator(), G2.generator(), random_scalar)
    vk = object()
    prover = LocalTxProver.__new__(LocalTxProver)
    prover.spend_params = prover.output_params = prover.convert_params = None
    prover.spend_vk = prover.output_vk = prover.convert_vk = vk
    results += bench_tx.measure(prover, XorShiftRng.from_seed(bytes(range(16))), 1, "cpu")
    results += bench_mixed_batch.measure(prover, XorShiftRng.from_seed(bytes(range(16))), 1, 1, 1, 3, "cpu")
    with pytest.raises(ValueError, match="cannot balance"):
        bench_mixed_batch.out_plan("A", "B", 1, 5, 10)
    for result, samples in results:
        assert len(samples) == 1
        TBL.emit(result, samples)
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [(r["metric"], r["unit"]) for r in lines] == [
        ("batch-verify groth16 host-pairing (B=2)", "ms/proof"),
        ("batch-verify groth16 device-pairing (B=2)", "ms/proof"),
        ("batch-verify redjubjub host (B=2)", "ms/proof"),
        ("batch-verify redjubjub device-msm (B=2)", "ms/proof"),
        ("full tx build+prove (1 spend, 1 convert, 2 outputs)", "s/tx"),
        ("full tx batch-validate (4 proofs + 2 sig batches)", "ms/tx"),
        ("mixed batch build+prove (1 spend, 1 convert, 3 output = 5 proofs)", "s/batch"),
        ("mixed batch validate (5 proofs + sig batches)", "s/batch"),
    ]
    assert bench_mixed_batch.out_plan("A", "B", 8, 8, 48) == [("A", 2_000)] * 31 + [("A", 1_000)] + [
        ("B", 2_000)] * 16
    for mod in (TBENCH, bench_batch, bench_tx, bench_mixed_batch, bench_verify):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main([])
