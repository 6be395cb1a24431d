"""Multi-process runtime: ``torch.distributed`` start-up and meshes over
every process's devices.

A rewrite (not a copy) of masp_tpu/parallel/distributed.py, with its names,
on ``torch.distributed`` in place of ``jax.distributed``:

* ``initialize``: idempotent start of the process group, its fields from the
  arguments, then MASP_COORDINATOR / MASP_NUM_PROCESSES / MASP_PROCESS_ID,
  then MASP_AUTO_DISTRIBUTED=1 (torchrun's environment, ``env://``); with
  none of them the run stays single-process. The backend is the caller's:
  NCCL by default (the card's), gloo for processes on the CPU.
* ``pod_mesh``: a named-axis mesh over the devices of every process, its
  positions (rank, local device) in row-major order. Each process computes
  only its own positions; parallel/mesh.py moves chunks between processes
  by point-to-point operations.
* ``local_job_slice`` / ``global_from_local``: a process's share of a batch
  of proofs, and the per-process rows joined into one tensor sharded over
  the mesh.

Single-process use (one card, the tests, a virtual mesh) needs nothing
here: ``initialize`` is a no-op then.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from masp_tpu_torch.parallel.mesh import Mesh, Sharded, shard

_initialized = False


def _dist():
    import torch.distributed as dist

    return dist


def _running() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return _dist().get_world_size() if _running() else 1


def process_index() -> int:
    return _dist().get_rank() if _running() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str = "nccl") -> bool:
    """Start (or skip) the multi-process runtime. Idempotent.

    Each field comes from its argument, then MASP_COORDINATOR ("host:port")
    / MASP_NUM_PROCESSES / MASP_PROCESS_ID; with no coordinator and no
    process count, MASP_AUTO_DISTRIBUTED=1 asks for torchrun's variables
    (``init_method="env://"``), else the run stays single-process. A
    coordinator host:port becomes ``init_method="tcp://host:port"``.
    ``backend`` is torch.distributed's ("nccl" by default, one card a
    process; "gloo" for processes on the CPU). Returns True when a
    multi-process runtime is running, False when single-process."""
    global _initialized
    if _initialized:
        return is_multiprocess()
    coordinator_address = coordinator_address or os.environ.get("MASP_COORDINATOR")
    if num_processes is None and "MASP_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["MASP_NUM_PROCESSES"])
    if process_id is None and "MASP_PROCESS_ID" in os.environ:
        process_id = int(os.environ["MASP_PROCESS_ID"])
    dist = _dist()
    if coordinator_address is None and num_processes is None:
        if os.environ.get("MASP_AUTO_DISTRIBUTED") == "1":
            dist.init_process_group(backend=backend, init_method="env://")
            _initialized = True
            return is_multiprocess()
        _initialized = True
        return False
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    if coordinator_address is None:
        init_method = "env://"
    else:
        host, port = coordinator_address.rsplit(":", 1)
        init_method = f"tcp://{host}:{port}"
    dist.init_process_group(backend=backend, init_method=init_method, **kwargs)
    _initialized = True
    return is_multiprocess()


def pod_mesh(axes: dict[str, int] | None = None, *, devices=None) -> Mesh:
    """A mesh over the devices of every process, with named axes.

    ``devices`` are this process's (default: every visible CUDA device;
    raises without one); every process passes as many. ``axes`` maps axis
    name -> size, outer to inner, the sizes multiplying to the global
    position count, with -1 once for "the rest" (as in a reshape); default
    one {"msm": n} axis. Positions are (rank, local device) in row-major
    order, the reference's layout off the TPU, so an inner axis that fits in
    one process exchanges inside it."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("pod_mesh: no CUDA device visible; pass devices= for another layout")
        devices = [torch.device("cuda", i) for i in range(count)]
    local = [str(torch.device(d)) for d in devices]
    everyone = [local]
    if is_multiprocess():
        everyone = [None] * process_count()
        _dist().all_gather_object(everyone, local)
    if len({len(d) for d in everyone}) != 1:
        raise ValueError(f"processes hold different device counts: {[len(d) for d in everyone]}")
    flat = [d for devs in everyone for d in devs]
    ranks = [r for r, devs in enumerate(everyone) for _ in devs]
    n = len(flat)
    if not axes:
        axes = {"msm": n}
    names = tuple(axes)
    sizes = list(axes.values())
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if known <= 0 or n % known:
            raise ValueError(f"cannot infer -1 axis: {n} devices over {axes}")
        sizes[sizes.index(-1)] = n // known
    if int(np.prod(sizes)) != n:
        raise ValueError(f"axes {dict(zip(names, sizes))} != {n} devices")
    return Mesh(np.asarray(flat, dtype=object).reshape(sizes), names, ranks=np.reshape(ranks, sizes),
                process_index=process_index())


@dataclass(frozen=True)
class JobSlice:
    """This process's contiguous slice of a global batch of B jobs."""

    start: int
    stop: int
    global_size: int

    def __len__(self) -> int:
        return self.stop - self.start

    def indices(self) -> range:
        return range(self.start, self.stop)


def local_job_slice(n_jobs: int, *, process_id: int | None = None,
                    process_count: int | None = None) -> JobSlice:
    """Partition n_jobs independent proof jobs across processes in
    contiguous blocks, the remainder spread over the leading processes."""
    pc = process_count if process_count is not None else (_dist().get_world_size() if _running() else 1)
    pid = process_id if process_id is not None else process_index()
    base, rem = divmod(n_jobs, pc)
    start = pid * base + min(pid, rem)
    return JobSlice(start, start + base + (1 if pid < rem else 0), n_jobs)


def global_from_local(mesh: Mesh, axis: str, local_rows) -> Sharded:
    """Join per-process rows into one tensor sharded along ``axis``. One
    process: its rows, split. Several: each process contributes its rows, in
    rank order; the row counts are all-gathered so that every process knows
    the global shape, and each position takes its chunk from its own
    process's rows (which must hold it)."""
    rows = torch.as_tensor(np.asarray(local_rows)) if not isinstance(local_rows, torch.Tensor) else local_rows
    if not is_multiprocess():
        return shard(mesh, rows, axis)
    counts = [None] * process_count()
    _dist().all_gather_object(counts, int(rows.shape[0]))
    offset, total = sum(counts[: process_index()]), sum(counts)
    n = mesh.shape[axis]
    if total % n:
        raise ValueError(f"{total} rows do not split into {n} chunks along {axis!r}")
    C = total // n
    shards = {}
    for p in mesh.local_positions():
        lo = mesh.axis_index(p, axis) * C - offset
        if lo < 0 or lo + C > rows.shape[0]:
            raise ValueError(f"position {p} holds global rows this process does not have")
        chunk = rows[lo : lo + C]
        shards[p] = torch.empty(chunk.shape, dtype=chunk.dtype, device=mesh.device(p)).copy_(chunk)
    return Sharded(mesh, axis, shards, (total,) + tuple(rows.shape[1:]))


__all__ = [
    "initialize", "is_multiprocess", "process_count", "process_index", "pod_mesh", "JobSlice",
    "local_job_slice", "global_from_local",
]
