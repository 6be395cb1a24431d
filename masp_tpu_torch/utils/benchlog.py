"""Append-only benchmark log: every successful measurement of the port's
entry points lands in BENCH_LOG with its raw samples, so medians stay
auditable and regressions bisectable.

Twin of masp_tpu/utils/benchlog.py: the same printed line, the same entry
keys and the same rule that logging never fails the bench. Two departures,
each marked below: the entry's "backend" names the card, and BENCH_LOG is
the port's own file (listed in .gitignore), not the JAX package's record
benches/bench_log.jsonl. No caller reads the log back to report a result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

# departs from the source: the port's own log, beside the package
BENCH_LOG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "benches", "bench_log.jsonl",
)
# end of departure


def backend() -> str:
    """The device the port's entry points measure on: the card's name from
    torch and the name and power limit that nvidia-smi reports, or "cpu"
    without a card."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        smi = smi.splitlines()[torch.cuda.current_device()] if smi else "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        smi = f"nvidia-smi failed: {exc}"
    return f"{torch.cuda.get_device_name()} ({smi})"


def emit(result: dict, samples: list | None = None, **extra) -> None:
    """Print one JSON result line AND append it (with raw samples and a
    timestamp) to the bench log. Logging failures never fail the bench."""
    print(json.dumps(result), flush=True)
    try:
        os.makedirs(os.path.dirname(BENCH_LOG), exist_ok=True)
        entry = dict(result)
        entry["ts"] = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        if samples is not None:
            entry["samples_s"] = [round(float(s), 5) for s in samples]
        entry.update(extra)
        # departs from the source: the card, not jax.default_backend()
        entry.setdefault("backend", backend())
        # end of departure
        with open(BENCH_LOG, "a") as f:
            f.write(json.dumps(entry) + "\n")
    except OSError as exc:
        print(f"benchlog: could not append {BENCH_LOG}: {exc}",
              file=sys.stderr)


__all__ = ["emit", "BENCH_LOG", "backend"]
