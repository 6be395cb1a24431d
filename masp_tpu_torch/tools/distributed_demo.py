"""A real multi-process run of the port's distributed path: N local
processes (default 2), the twin of the JAX package's tools/distributed_demo.py.

The parent starts N workers. Each joins one ``torch.distributed`` process
group through ``parallel.distributed.initialize`` on a localhost
coordinator (gloo on the CPU; NCCL, one card a worker, only where every
worker has a card of its own), builds a ``pod_mesh`` over the global
positions (8 by default, as the reference's; ``--positions``) and runs:

1. ``local_job_slice``: each process's contiguous share of a batch of 6 jobs;
2. ``global_from_local``: per-process rows joined into one tensor sharded
   over the mesh, its per-position sums all-gathered and checked against
   the host's sum;
3. the mesh prover (``create_proof_from_assembly(mesh=)``) over the global
   mesh, its chunks crossing processes by point-to-point operations, held
   against the host prover (groth16/reference.py) on every process;
4. a dp batch: each process proves its ``local_job_slice`` of 2N proofs
   through the batch prover on its own device, the 192-byte proofs are
   all-gathered (``all_gather_object``) and every process runs
   ``verify_proofs_batch`` over the whole batch, and again with one public
   input altered, which must fail.

Each worker prints one "DISTRIBUTED DEMO PASS" line.

    python masp_tpu_torch/tools/distributed_demo.py [--nproc N] [--positions P] [--timeout SECONDS]
    python masp_tpu_torch/tools/distributed_demo.py --worker I N PORT BACKEND P   (one worker)
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
POSITIONS = 8  # positions over all processes by default, as the dry run's mesh
WORKER_TIMEOUT_S = 1800


def worker(pid: int, nproc: int, port: int, backend: str, positions: int) -> int:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from masp_tpu_torch.parallel import distributed as D
    from masp_tpu_torch.parallel import mesh as PM

    torch.set_num_threads(2)
    t0 = time.perf_counter()

    def log(msg):
        print(f"[p{pid}] {msg} ({time.perf_counter() - t0:.1f} s)", flush=True)

    if not D.initialize(f"localhost:{port}", nproc, pid, backend=backend):
        raise AssertionError("expected a multi-process runtime")
    if D.process_count() != nproc or D.process_index() != pid:
        raise AssertionError(f"process {D.process_index()} of {D.process_count()}, not {pid} of {nproc}")
    if backend == "nccl":
        torch.cuda.set_device(pid)
        local = [torch.device("cuda", pid)]
    else:
        local = [torch.device("cpu")] * (positions // nproc)
    log(f"initialized: {nproc} processes over {backend}, {len(local)} local positions")

    # 1. job partitioning: 6 jobs over the processes, contiguous blocks
    sl = D.local_job_slice(6)
    covered = sorted(i for q in range(nproc) for i in D.local_job_slice(6, process_id=q, process_count=nproc).indices())
    if covered != list(range(6)):
        raise AssertionError(f"job slices cover {covered}")
    log(f"job slice: {sl.start}..{sl.stop} of {sl.global_size}")

    # 2. global_from_local, and a sum over every position checked against the host's
    mesh = D.pod_mesh({"msm": -1}, devices=local)
    n_global = mesh.shape["msm"]
    if n_global != nproc * len(local) or len(mesh.local_positions()) != len(local):
        raise AssertionError(f"pod mesh {mesh.shape}, {len(mesh.local_positions())} local positions")
    rows_per_pos = 2
    n_local = len(local) * rows_per_pos
    local_rows = np.arange(pid * n_local, (pid + 1) * n_local, dtype=np.int64).reshape(n_local, 1)
    garr = D.global_from_local(mesh, "msm", local_rows)
    if garr.shape != (n_global * rows_per_pos, 1):
        raise AssertionError(f"global shape {garr.shape}")
    for p in mesh.local_positions():
        if garr.shards[p].device != mesh.device(p):
            raise AssertionError(f"position {p} holds its rows on {garr.shards[p].device}")
    sums = PM.all_gather(PM.smap(lambda p, v: v.sum().reshape(1), garr, axis="msm"))
    got, want = int(sums.first.sum()), sum(range(n_global * rows_per_pos))
    if got != want:
        raise AssertionError(f"global sum {got}, host {want}")
    if PM.gather(garr).reshape(-1).tolist() != list(range(n_global * rows_per_pos)):
        raise AssertionError("gather does not give the global rows")
    log(f"global sum over the {n_global}-position mesh OK ({got})")

    # 3. the mesh prover over the global mesh against the host prover
    from masp_tpu_torch.groth16 import prover as TP
    from masp_tpu_torch.groth16 import synthesis as S
    from masp_tpu_torch.groth16.reference import host_proof
    from masp_tpu_torch.host.bls12_381 import R
    from masp_tpu_torch.tools.multichip import Chain, random_params

    TP.MSM_C = 4  # 16 buckets: a short reduction on the CPU; the proof does not depend on c
    asm, _ = S.synthesize_witness(Chain(777), use_tape=False)
    params = random_params(asm, 7)  # the same seed in every process
    proof = TP.create_proof_from_assembly(asm, params, 11, 22, mesh=mesh)
    if proof != host_proof(asm, params, 11, 22):
        raise AssertionError("the multi-process mesh prover disagrees with the host prover")
    log(f"mesh proof over {nproc} processes x {len(local)} positions OK: proof == host reference")

    # 4. dp batch: each process proves its slice on its own device, the
    # proofs are all-gathered and every process checks the whole batch
    import torch.distributed as dist

    from masp_tpu_torch.groth16.generator import generate_random_parameters
    from masp_tpu_torch.host.rng import XorShiftRng
    from masp_tpu_torch.host.structures import Proof, prepare_verifying_key
    from masp_tpu_torch.host.verifier import verify_proofs_batch

    params = generate_random_parameters(Chain(), XorShiftRng.from_seed(bytes(range(16, 32))), device=local[0])
    log("parameters generated")
    n_jobs = 2 * nproc
    jobs = D.local_job_slice(n_jobs)
    x0s = [700 + j for j in range(n_jobs)]
    outs = [pow(x, 1 << 12, R) for x in x0s]
    witnesses = (S.synthesize_witness(Chain(x0s[j]), use_tape=False)[0] for j in jobs.indices())
    rs = [(11 + j, 22 + j) for j in jobs.indices()]
    blobs = [p.write() for p in TP.create_proofs_from_assemblies(witnesses, params, rs, device=local[0])]
    log(f"dp batch: jobs {jobs.start}..{jobs.stop} of {n_jobs} proved locally")
    gathered = [None] * nproc
    dist.all_gather_object(gathered, blobs)
    everything = [b for part in gathered for b in part]
    if len(everything) != n_jobs or any(len(b) != 192 for b in everything):
        raise AssertionError(f"gathered {len(everything)} proofs of {[len(b) for b in everything]} bytes")
    proofs = [Proof.read(b) for b in everything]
    pvk = prepare_verifying_key(params.vk)
    vrng = XorShiftRng.from_seed(bytes(range(16)))
    if not verify_proofs_batch(pvk, vrng, proofs, [[o] for o in outs]):
        raise AssertionError("the gathered dp batch failed batch verification")
    bad = [[o] for o in outs]
    bad[0] = [(outs[0] + 1) % R]
    if verify_proofs_batch(pvk, vrng, proofs, bad):
        raise AssertionError("batch verification accepted a corrupted public input")
    log(f"dp batch of {n_jobs} proofs all-gathered and batch-verified OK (negative check OK)")
    print(f"[p{pid}] DISTRIBUTED DEMO PASS", flush=True)
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parent(nproc: int = 2, positions: int = POSITIONS, timeout: float = WORKER_TIMEOUT_S) -> int:
    """Start the workers and wait for them, echoing their output. A worker
    that fails stops the others (they would wait for it), and so does the
    time limit: every worker is ended before this returns."""
    import torch

    if positions % nproc:
        raise ValueError(f"{nproc} processes do not divide {positions} positions")
    backend = "nccl" if torch.cuda.is_available() and torch.cuda.device_count() >= nproc else "gloo"
    port = _free_port()
    logs, procs = [], []

    with tempfile.TemporaryDirectory() as tmp:
        for i in range(nproc):
            logs.append(open(os.path.join(tmp, f"worker{i}.log"), "w+"))
            procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--worker", str(i),
                                           str(nproc), str(port), backend, str(positions)], cwd=REPO,
                                          stdout=logs[i],
                                          stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        rc = 0
        for p, log in zip(procs, logs):
            log.seek(0)
            out = log.read()
            log.close()
            sys.stdout.write(out)
            if p.returncode != 0 or "DISTRIBUTED DEMO PASS" not in out:
                rc = 1
    print("distributed demo:", "PASS" if rc == 0 else "FAIL", flush=True)
    return rc


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        sys.exit(worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], int(sys.argv[6])))

    def arg(name, default, kind):
        return kind(sys.argv[sys.argv.index(name) + 1]) if name in sys.argv else default

    sys.exit(parent(nproc=arg("--nproc", 2, int), positions=arg("--positions", POSITIONS, int),
                    timeout=arg("--timeout", WORKER_TIMEOUT_S, float)))
