"""Stage timing for the prover: host wall time plus CUDA-event device time.

Port of the span timer of masp_tpu/utils/tracing.py. ``span(name)`` is a
no-op unless MASP_TRACE=1 at import or ``enable()``; when enabled, each span
records its host wall time and, on a CUDA device, a pair of CUDA events on
the current stream, so ``report()`` can give the stream time between them
(work enqueued inside the span, plus any idle gap the host left). Reading
the report synchronises. ``device_profile(log_dir)`` records a
``torch.profiler`` trace of the CPU and, where there is one, the card into
``log_dir`` as a Chrome trace (the reference's XProf device profile).
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch


class Tracer:
    """Flat per-name span accumulator (single-threaded use per instance)."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._records: list = []

    @contextmanager
    def span(self, name: str, device=None):
        if not self.enabled:
            yield
            return
        events = None
        if device is not None and torch.device(device).type == "cuda":
            events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            events[0].record()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            host = time.perf_counter() - t0
            if events is not None:
                events[1].record()
            self._records.append((name, host, events))

    def reset(self) -> None:
        self._records = []

    def report(self) -> dict:
        """{name: {"count", "host_s", "host_each_s", "device_ms"}}: the
        span's count, total host seconds, host seconds of each occurrence,
        and total stream ms (None for spans that ran on the CPU)."""
        if any(ev is not None for _, _, ev in self._records):
            torch.cuda.synchronize()
        out: dict = {}
        for name, host, events in self._records:
            ent = out.setdefault(name, {"count": 0, "host_s": 0.0, "host_each_s": [], "device_ms": None})
            ent["count"] += 1
            ent["host_s"] += host
            ent["host_each_s"].append(host)
            if events is not None:
                ent["device_ms"] = (ent["device_ms"] or 0.0) + events[0].elapsed_time(events[1])
        return out


_tracer = Tracer(enabled=os.environ.get("MASP_TRACE") == "1")


def enable(on: bool = True) -> None:
    _tracer.enabled = on


def span(name: str, device=None):
    """Span against the process tracer (a no-op unless enabled)."""
    return _tracer.span(name, device)


def report() -> dict:
    return _tracer.report()


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


__all__ = ["Tracer", "span", "report", "reset", "enable", "device_profile"]
