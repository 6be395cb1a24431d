"""Stage timing for the prover: nested host wall-time spans plus CUDA-event
device time.

Port of the span timer of masp_tpu/utils/tracing.py: ``Tracer`` keeps the
reference's tree of ``_Node(total, count, children)``, ``rows()`` flattens
it to (depth, name, total_s, count, self_s), and ``report()`` renders the
reference's indented table. ``span(name)`` against the module tracer is a
no-op unless MASP_TRACE=1 at import or ``enable()``. Beyond the reference,
a span given a CUDA device records a pair of CUDA events on the current
stream, so ``report()`` adds a column of stream ms (work enqueued inside the
span, plus any idle gap the host left), and ``stats()`` sums each name over
every depth: {name: {"count", "host_s", "host_each_s", "device_ms"}}.
Reading stream times synchronises. ``device_profile(log_dir)`` records a
``torch.profiler`` trace of the CPU and, where there is one, the card into
``log_dir`` as a Chrome trace (the reference's XProf device profile).
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass
class _Node:
    total: float = 0.0
    count: int = 0
    children: dict = field(default_factory=dict)
    # beyond the reference: host seconds of each occurrence, and the CUDA
    # event pair of each occurrence that ran on a card
    each: list = field(default_factory=list)
    events: list = field(default_factory=list)


def _stream_ms(node: _Node) -> float | None:
    """Total stream ms between the node's event pairs, None if it has none
    (the caller has synchronised)."""
    if not node.events:
        return None
    return sum(start.elapsed_time(end) for start, end in node.events)


def _synchronize(nodes) -> None:
    """Wait for the card where any node recorded events, so that their
    elapsed times can be read."""
    if any(node.events for node in nodes):
        torch.cuda.synchronize()


class Tracer:
    """Hierarchical span accumulator. Thread-compatible (single-threaded
    use per instance; the module-level tracer is per-process)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.root = _Node()
        self._stack: list[_Node] = [self.root]

    @contextmanager
    def span(self, name: str, device=None):
        if not self.enabled:
            yield
            return
        parent = self._stack[-1]
        node = parent.children.setdefault(name, _Node())
        self._stack.append(node)
        events = None
        if device is not None and torch.device(device).type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if events is not None:
                events[1].record()
                node.events.append(events)
            node.total += dt
            node.count += 1
            node.each.append(dt)
            self._stack.pop()

    def reset(self):
        self.root = _Node()
        self._stack = [self.root]

    def _walk(self):
        """(depth, name, node) in pre-order."""
        out = []

        def walk(node: _Node, depth: int):
            for name, child in node.children.items():
                out.append((depth, name, child))
                walk(child, depth + 1)

        walk(self.root, 0)
        return out

    def rows(self):
        """Flatten to (depth, name, total_s, count, self_s) rows."""
        return [(depth, name, node.total, node.count,
                 node.total - sum(c.total for c in node.children.values()))
                for depth, name, node in self._walk()]

    def report(self) -> str:
        walked = self._walk()
        if not walked:
            return "(no spans recorded)"
        nodes = [node for _, _, node in walked]
        _synchronize(nodes)
        stream = any(node.events for node in nodes)
        width = max(len("  " * d + n) for d, n, _ in walked) + 2
        lines = [f"{'span':<{width}} {'total':>9} {'calls':>6} {'self':>9}" + (f" {'stream':>11}" if stream else "")]
        for (depth, name, total, count, self_s), node in zip(self.rows(), nodes):
            label = "  " * depth + name
            line = f"{label:<{width}} {total:>8.3f}s {count:>6} {self_s:>8.3f}s"
            if stream:
                ms = _stream_ms(node)
                line += f" {'n/a':>11}" if ms is None else f" {ms:>9.3f}ms"
            lines.append(line)
        return "\n".join(lines)

    def stats(self) -> dict:
        """{name: {"count", "host_s", "host_each_s", "device_ms"}}, each name
        summed over every depth it was opened at: its count, total host
        seconds, host seconds of each occurrence, and total stream ms (None
        for spans that ran on the CPU)."""
        walked = self._walk()
        _synchronize([node for _, _, node in walked])
        out: dict = {}
        for _, name, node in walked:
            ent = out.setdefault(name, {"count": 0, "host_s": 0.0, "host_each_s": [], "device_ms": None})
            ent["count"] += node.count
            ent["host_s"] += node.total
            ent["host_each_s"] += node.each
            ms = _stream_ms(node)
            if ms is not None:
                ent["device_ms"] = (ent["device_ms"] or 0.0) + ms
        return out


_tracer = Tracer(enabled=os.environ.get("MASP_TRACE") == "1")


def enable(on: bool = True) -> None:
    _tracer.enabled = on


def span(name: str, device=None):
    """Module-level span against the process tracer (cheap no-op unless
    MASP_TRACE=1 / enable())."""
    return _tracer.span(name, device)


def report() -> str:
    return _tracer.report()


def stats() -> dict:
    return _tracer.stats()


def reset() -> None:
    _tracer.reset()


@contextmanager
def device_profile(log_dir: str | None):
    """Profile the enclosed work with torch.profiler (CPU, and CUDA where a
    card is present) and write it into ``log_dir`` as a Chrome trace
    (open it in Perfetto or chrome://tracing). No-op when log_dir is
    falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


__all__ = ["Tracer", "span", "report", "stats", "reset", "enable", "device_profile"]
