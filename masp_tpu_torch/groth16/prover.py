"""Groth16 prover, main path: witness -> NTT quotient -> MSMs -> proof.

Port of masp_tpu/groth16/prover.py in its accelerator configuration: window
c = 8, unsigned digits extracted on the device from the witness limbs
(balanced signed digits with MASP_MSM_SIGNED=1), the boolean split of the
l/a/b queries, the on-device a/b/c evaluation (on the host with
MASP_ABC_DEVICE=0), and the sorted MSM on the projective scan ladder with
the sequential bucket reduction (``ops.msm_sorted.AFFINE_LADDER``; set it
True for the reference accelerator's batch-affine ladder with the wide
reduction, which the H100 runs slower). With a ``mesh``
(parallel/mesh.py), every NTT runs element-sharded and the five MSMs
point-sharded over its "msm" axis, as the reference's ``mesh=`` route: the
a/b/c values come from the host, no query is split, and the proof is the
single-device proof byte for byte. A proof is enqueued on the current CUDA stream, its inputs
copied in from pinned host memory, its five query results made affine on the
device and copied out into pinned host memory, all without waiting; then it
is drained: the host waits for its copies and assembles the proof. The batch
prover keeps a window of proofs enqueued ahead of the one it drains.

Departures from the reference that leave every result as it is: the
windows of an MSM run batched (ops/msm_sorted.py), the three a/b/c NTTs run
as one batch, and the bucket reduction of the four full-width G1 MSMs runs
as one batch of four.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from masp_tpu_torch import resolve_device
from masp_tpu_torch.groth16 import synthesis as S
from masp_tpu_torch.groth16.domain import Domain
from masp_tpu_torch.groth16.generator import coeff_ints, densities
from masp_tpu_torch.groth16.params import Assembly, Parameters
from masp_tpu_torch.host import native
from masp_tpu_torch.host.bls12_381 import R
from masp_tpu_torch.host.rng import random_scalar
from masp_tpu_torch.host.structures import Proof
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops import msm_sorted as MS
from masp_tpu_torch.ops import weierstrass as W
from masp_tpu_torch.ops.field import FR
from masp_tpu_torch.ops.limbs import normalize
from masp_tpu_torch.ops.msm import identity_rows
from masp_tpu_torch.ops.projective import unpack_rows
from masp_tpu_torch.parallel import mesh as PM
from masp_tpu_torch.utils.tracing import span


def msm_flags(env) -> dict:
    """The prover's MSM configuration from the JAX package's variables, with
    the port's defaults: MASP_MSM_C, the window width of the full-width MSMs
    (8; 2 .. 16, and on the batch-affine ladder only widths whose window
    count is a power of two); MASP_MSM_SPLIT ("1"), the boolean split of the
    l/a/b queries; MASP_MSM_SPLIT_MIN (32768), the bit wires a query needs
    for its split (Spend: 50-68k per query; Output and Convert: 17-24k,
    where the split does not pay); MASP_MSM_SIGNED ("0"), balanced signed
    digits ("1"; the digits are extracted on the device, so the reference's
    condition holds); MASP_ABC_DEVICE ("1"), the a/b/c values on the device
    ("0": on the host, through the native evaluator). A value of these, or
    of MASP_MSM_FUSED, MASP_MSM_BGMW_H, MASP_MSM (the sorted MSM),
    MASP_MSM_STACK (the stacked MSMs, "0") or MASP_MSM_FROM_LIMBS (digits
    on the device, "1"), that the port does not implement raises
    ValueError. MASP_MSM_VMAP_WINDOWS (how XLA batches the windows) and the
    pairing's MASP_PAIR_MILLER_CHUNK and MASP_PAIR_EXP_CHUNK (how long one
    XLA program is) have no effect in the port: it runs every window in one
    batch and the pairing as it goes."""
    c = int(env.get("MASP_MSM_C", "8"))
    if not 2 <= c <= 16:
        raise ValueError(f"MASP_MSM_C={c}: the window width must be 2 .. 16")
    switches = {name: env.get(name, default) for name, default in (("MASP_MSM_SIGNED", "0"),
                                                                   ("MASP_ABC_DEVICE", "1"))}
    for name, value in switches.items():
        if value not in ("0", "1"):
            raise ValueError(f"{name}={value!r}: the port takes '0' or '1'")
    signed = switches["MASP_MSM_SIGNED"] == "1"
    n_windows = MS.n_windows_for(c, signed)
    if MS.AFFINE_LADDER and not MS.affine_ladder_takes(n_windows, 1):
        raise ValueError(f"MASP_MSM_C={c}: {n_windows} windows, which the batch-affine ladder "
                         f"cannot take (a power-of-two count is needed)")
    for name, default, implemented in (("MASP_MSM_FUSED", "0", "0"), ("MASP_MSM_BGMW_H", "0", "0"),
                                       ("MASP_MSM", "sorted", "sorted"), ("MASP_MSM_STACK", "0", "0"),
                                       ("MASP_MSM_FROM_LIMBS", "1", "1")):
        if env.get(name, default) != implemented:
            raise ValueError(f"{name}={env[name]!r} is not implemented in the port (it runs {implemented!r})")
    return {"MSM_C": c, "MSM_SPLIT": env.get("MASP_MSM_SPLIT", "1") == "1",
            "MSM_SPLIT_MIN": int(env.get("MASP_MSM_SPLIT_MIN", "32768")), "MSM_SIGNED": signed,
            "ABC_DEVICE": switches["MASP_ABC_DEVICE"] == "1"}


_FLAGS = msm_flags(os.environ)
# window width of the full-width MSMs
MSM_C = _FLAGS["MSM_C"]
# whether a query is split into a {0,1}-scalar part and a full-width part,
# and from how many structural bit wires
MSM_SPLIT = _FLAGS["MSM_SPLIT"]
MSM_SPLIT_MIN = _FLAGS["MSM_SPLIT_MIN"]
# balanced signed digits in every full-width MSM
MSM_SIGNED = _FLAGS["MSM_SIGNED"]
# the a/b/c values on the device (else on the host; always so with a mesh)
ABC_DEVICE = _FLAGS["ABC_DEVICE"]

G1_QUERIES = ("h", "l", "a", "b_g1")
# the fetch's groups: (group ops, queries, host decoder of affine limbs)
GROUPS = ((W.G1Ops, G1_QUERIES, W.decode_affine_g1), (W.G2Ops, ("b_g2",), W.decode_affine_g2))


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


# --- structure of the circuit (cached per parameters) ------------------------

def boolean_var_mask(asm: Assembly) -> np.ndarray:
    """(n_vars,) bool mask of the variables the R1CS structure forces into
    {0, 1}: seeds (ONE - v) * v = 0, closed under xor (2a) * b = (a + b - v),
    and a * b = v, and-not a * (ONE - b) = v, nor (ONE - a) * (ONE - b) = v
    to a fixpoint. Variable 0 (ONE) is never in the mask."""
    n = asm.num_constraints
    R1 = R - 1
    coeffs = coeff_ints(asm.coeffs)
    var_idx = asm.var_idx.tolist()
    indptr = asm.indptr.tolist()

    def row(k, j):
        lo, hi = indptr[k * n + j], indptr[k * n + j + 1]
        return [(var_idx[e], coeffs[e]) for e in range(lo, hi)]

    def bit_factor(r):
        """(v) or (ONE - v) or (ONE): the dependency list if the factor is a
        bit whenever its variables are, else None."""
        d = dict(r)
        if len(d) == 1:
            ((v, co),) = d.items()
            if co != 1:
                return None
            return [] if v == 0 else [v]
        if len(d) == 2 and d.get(0) == 1:
            others = [v for v in d if v != 0]
            if d[others[0]] == R1:
                return [others[0]]
        return None

    seeds, rules = [], []
    for j in range(n):
        a_row, b_row, c_row = row(0, j), row(1, j), row(2, j)
        da, db, dc = dict(a_row), dict(b_row), dict(c_row)
        if not dc and len(db) == 1 and len(da) == 2 and da.get(0) == 1:
            bv, bc = b_row[0]
            if bc == 1 and bv != 0 and da.get(bv) == R1:
                seeds.append(bv)
                continue
        if len(db) == 1 and len(da) == 1 and len(dc) == 3:
            bv, bc = next(iter(db.items()))
            av, ac = next(iter(da.items()))
            if bc == 1 and ac == 2 and dc.get(av) == 1 and dc.get(bv) == 1:
                rest = [v for v in dc if v not in (av, bv)]
                if len(rest) == 1 and dc[rest[0]] == R1 and rest[0] != 0:
                    rules.append((rest[0], [av, bv]))
                    continue
        if len(dc) == 1:
            cv, cc = next(iter(dc.items()))
            if cc == 1 and cv != 0:
                fa, fb = bit_factor(a_row), bit_factor(b_row)
                if fa is not None and fb is not None:
                    rules.append((cv, fa + fb))

    mask = np.zeros(asm.num_vars, dtype=bool)
    mask[seeds] = True
    dep_rules: dict[int, list[int]] = {}
    for ridx, (_out, deps) in enumerate(rules):
        for d in deps:
            dep_rules.setdefault(d, []).append(ridx)
    pending = [r for r in range(len(rules)) if not rules[r][1]]
    pending += [r for s in seeds for r in dep_rules.get(s, [])]
    while pending:
        out, deps = rules[pending.pop()]
        if mask[out] or not all(mask[d] for d in deps):
            continue
        mask[out] = True
        pending.extend(dep_rules.get(out, []))
    mask[0] = False  # ONE rides the verifier-side IC, never split
    return mask


def _structure(cache: dict, asm: Assembly) -> dict:
    """Per-circuit structure, cached in the parameters' device dict (which
    names the device under "dev"): densities, the boolean mask and the
    device CSR of the a|b|c rows."""
    key = (asm.num_constraints, asm.num_inputs, asm.num_vars, asm.var_idx.shape[0])
    st = cache.get("structure")
    if st is not None and st["key"] == key:
        return st
    n = asm.num_constraints
    m = _next_pow2(n)
    dev = cache["dev"]
    rows = np.repeat(np.arange(3 * n, dtype=np.int64), np.diff(asm.indptr))
    seg = (rows // n) * m + (rows % n)
    # per-term coefficients as Montgomery rows: mont_mul(mont(c), v) = c v
    uniq, inv = np.unique(asm.coeffs, axis=0, return_inverse=True)
    mont = F.encode(FR, coeff_ints(uniq)) if uniq.shape[0] else np.zeros((0, FR.L), np.uint32)
    a_density, b_density = densities(asm)
    st = {
        "key": key,
        "m": m,
        "a_density": a_density,
        "b_density": b_density,
        "mask": boolean_var_mask(asm),
        "var_idx": torch.as_tensor(asm.var_idx, device=dev),
        "seg": torch.as_tensor(seg, device=dev),
        "coeff16": torch.as_tensor(mont.astype(np.int32)[inv.reshape(-1)], device=dev),
    }
    cache["structure"] = st
    return st


# --- parameters on the device ---------------------------------------------------

def _identity_row(g2: bool) -> np.ndarray:
    fops = W.G2Ops if g2 else W.G1Ops
    return identity_rows(fops, (1,), "cpu").numpy()


def _pad_pow2(rows: np.ndarray, g2: bool, floor_log2: int = 0) -> np.ndarray:
    n_pad = 1 << max(floor_log2, (max(rows.shape[0], 1) - 1).bit_length())
    out = np.tile(_identity_row(g2), (n_pad, 1))
    out[: rows.shape[0]] = rows
    return out


def prepare_device_params(params: Parameters, device, mesh=None) -> None:
    """Copy every query to the device once, as packed rows padded with
    identities to its own power of two (the padding changes no result).
    With a mesh, each query pads to at least the "msm" axis's size and is
    placed sharded over that axis (``device`` is not read: the mesh names
    the devices); the cache is keyed by the mesh's layout and cleared when
    it changes."""
    key = None if mesh is None else mesh.key
    dev = resolve_device(device) if mesh is None else mesh.device(mesh.local_positions()[0])
    if params.device.get("dev") == dev and params.device.get("mesh") == key:
        return
    params.device.clear()
    params.device["dev"] = dev
    params.device["mesh"] = key
    for q in G1_QUERIES + ("b_g2",):
        if mesh is None:
            params.device[q] = torch.as_tensor(_pad_pow2(params.rows(q), q == "b_g2"), device=dev)
        else:
            rows = _pad_pow2(params.rows(q), q == "b_g2", (mesh.shape["msm"] - 1).bit_length())
            params.device[q] = PM.shard(mesh, rows, "msm")


def prepare_split_queries(params: Parameters, asm: Assembly) -> None:
    """Split l/a/b_g1/b_g2 into a {0,1}-scalar part and a full-width part by
    the structural boolean mask, where at least MSM_SPLIT_MIN exponents of a
    query are bit wires (and not all of them). Witness values are checked
    against the mask at prove time. Nothing is split for a mesh: its five
    queries go whole through the sharded MSM."""
    if params.device.get("mesh") is not None:
        return
    st = _structure(params.device, asm)
    if params.device.get("split_key") == (st["key"], MSM_SPLIT, MSM_SPLIT_MIN):
        return
    mask = st["mask"]
    qmasks = {
        "l": mask[asm.num_inputs :],
        "a": mask[st["a_density"]],
        "b_g1": mask[st["b_density"]],
        "b_g2": mask[st["b_density"]],
    }
    dev = params.device["dev"]
    for name, qm in qmasks.items():
        for k in ("_small", "_full", "_qmask"):
            params.device.pop(name + k, None)
        rows = params.rows(name)
        if qm.shape[0] != rows.shape[0]:
            raise ValueError(f"query {name!r} has {rows.shape[0]} points, the circuit {qm.shape[0]}")
        n_small = int(qm.sum())
        if not MSM_SPLIT or n_small < MSM_SPLIT_MIN or n_small == qm.shape[0]:
            continue
        g2 = name == "b_g2"
        params.device[name + "_small"] = torch.as_tensor(_pad_pow2(rows[qm], g2, 3), device=dev)
        params.device[name + "_full"] = torch.as_tensor(_pad_pow2(rows[~qm], g2, 3), device=dev)
        params.device[name + "_qmask"] = qm
    params.device["split_key"] = (st["key"], MSM_SPLIT, MSM_SPLIT_MIN)


# --- the h quotient ----------------------------------------------------------------

def h_pipeline(dom: Domain, abc, inputs_mont: bool = False):
    """(3, m, 16) a/b/c evaluations -> (m, 16) Montgomery h coefficients:
    iNTT, coset NTT, a*b - c, divide by Z, inverse coset NTT. Canonical
    limbs in unless ``inputs_mont``."""
    if not inputs_mont:
        abc = F.to_mont(FR, abc)
    abc = dom.coset_fft(dom.ifft(abc))
    t = F.sub(FR, F.mont_mul(FR, abc[0], abc[1]), abc[2])
    return dom.icoset_fft(dom.divide_by_z_on_coset(t))


def _abc_h(dom: Domain, st: dict, v16):
    """On-device a/b/c evaluation fused with the h pipeline. Each
    constraint's value is the sum of mont(c) * v products (canonical, < r);
    the int64 column sums normalise to 16 limbs S0 plus an overflow limb
    s16, and since 2^256 = R_fr the Montgomery form of the total is
    to_mont(S0) + to_mont(to_mont(s16))."""
    m = dom.m
    prods = F.mont_mul(FR, st["coeff16"], v16[st["var_idx"]])
    S = torch.zeros(3 * m, FR.L, dtype=torch.int64, device=v16.device)
    S.index_add_(0, st["seg"], prods.to(torch.int64))
    S0, s16 = normalize(S)
    s16rows = torch.zeros_like(S0)
    s16rows[:, 0] = s16
    vals = F.add(FR, F.to_mont(FR, S0), F.to_mont(FR, F.to_mont(FR, s16rows)))
    return h_pipeline(dom, vals.reshape(3, m, FR.L), inputs_mont=True)


def _h_scalar_input(h_coeffs, m: int, n_g1: int):
    """h scalars for the MSM as canonical limb rows, zero-padded to n_g1
    (bellman drops the last coefficient: degree <= m - 2)."""
    out = torch.zeros(n_g1, FR.L, dtype=torch.int32, device=h_coeffs.device)
    out[: m - 1] = F.from_mont(FR, h_coeffs[: m - 1])
    return out


def _h_scalars_sharded(mesh, h, m: int, n_h: int):
    """The h scalars of a mesh proof, on the h query's shard boundaries.
    ``h`` holds the m coefficients sharded over "msm"; the query holds n_h
    rows. Where n_h = m the NTT's chunks are the MSM's, and each position
    converts its own chunk (the last position zeroes the dropped last
    coefficient); else the m rows are gathered, padded and split again."""
    D = mesh.shape["msm"]
    if n_h != m:
        return PM.shard(mesh, _h_scalar_input(PM.gather(h), m, n_h), "msm")

    def local(p, v):
        out = F.from_mont(FR, v)
        if mesh.axis_index(p, "msm") == D - 1:
            out[-1] = 0
        return out

    return PM.smap(local, h, axis="msm")


def _host_abc(asm: Assembly, m: int) -> np.ndarray:
    """(3, m, 16) int32 canonical 16-bit limbs of the per-constraint A, B
    and C values, zero-padded to m, evaluated on the host: by the native
    evaluator where it builds (the reference's _compute_abc_limbs), else in
    Python integers."""
    n = asm.num_constraints
    if native.available():
        vals = native.eval_lc_rows_native(np.ascontiguousarray(asm.indptr, dtype=np.int64),
                                          np.ascontiguousarray(asm.var_idx, dtype=np.int64),
                                          np.ascontiguousarray(asm.coeffs), np.ascontiguousarray(asm.assignment))
    else:
        from masp_tpu_torch.groth16.reference import host_abc
        from masp_tpu_torch.groth16.synthesis import _u64x4

        vals = _u64x4([v for part in host_abc(asm) for v in part])
    out = np.zeros((3, m, FR.L), dtype=np.int32)
    out[:, :n] = np.ascontiguousarray(vals).view("<u2").reshape(3, n, FR.L)
    return out


# --- MSMs ------------------------------------------------------------------------

def _limbs(arr_u64: np.ndarray, n_padded: int) -> np.ndarray:
    """(n, 4) uint64 scalars -> (n_padded, 16) int32 16-bit limb rows."""
    out = np.zeros((n_padded, 16), dtype=np.int32)
    out[: arr_u64.shape[0]] = np.ascontiguousarray(arr_u64).view("<u2").reshape(-1, 16)
    return out


def _host_inputs(params: Parameters, asm: Assembly, st: dict, abc_on_device: bool) -> dict:
    """Every per-proof array the device needs, built on the host: the
    witness limb rows (``abc_on_device``) or the a/b/c values, and per query
    the full-width scalar limb rows and, when split, the bit column. Raises
    if a witness value violates the boolean split."""
    dev = params.device
    full_u64 = asm.assignment
    if abc_on_device:
        out = {"v16": _limbs(full_u64, full_u64.shape[0])}
    else:
        out = {"abc": _host_abc(asm, st["m"])}
    scalars = {
        "l": full_u64[asm.num_inputs :],
        "a": full_u64[st["a_density"]],
        "b_g1": full_u64[st["b_density"]],
        "b_g2": full_u64[st["b_density"]],
    }
    for q, arr in scalars.items():
        if q + "_small" not in dev:
            out[q + "/limbs"] = _limbs(arr, dev[q].shape[0])
            continue
        qm = dev[q + "_qmask"]
        small, full = arr[qm], arr[~qm]
        if small.size and (small[:, 1:].any() or (small[:, 0] > 1).any()):
            raise ValueError(f"boolean-split mask violated by witness for query {q!r}")
        bits = np.zeros(dev[q + "_small"].shape[0], dtype=np.int32)
        bits[: small.shape[0]] = small[:, 0]
        out[q + "/bits"] = bits
        out[q + "/limbs"] = _limbs(full, dev[q + "_full"].shape[0])
    return out


def _msms(params: Parameters, inputs: dict, h_limbs):
    """Enqueue every MSM; returns {query: [projective rows]} (one row per
    part) without synchronising."""
    dev = params.device["dev"]
    out = {q: [] for q in G1_QUERIES + ("b_g2",)}
    g1_buckets = []
    for q in G1_QUERIES + ("b_g2",):
        fops = W.G2Ops if q == "b_g2" else W.G1Ops
        with span(f"msm/{q}", dev):
            if q == "h":
                pts, limbs = params.device["h"], h_limbs
            elif q + "/bits" in inputs:
                out[q].append(MS.masked_sum(fops, params.device[q + "_small"], inputs[q + "/bits"]))
                pts, limbs = params.device[q + "_full"], inputs[q + "/limbs"]
            else:
                pts, limbs = params.device[q], inputs[q + "/limbs"]
            digits = MS.windows_from_limbs(limbs, MSM_C, MSM_SIGNED)
            buckets = MS.window_buckets(fops, pts, digits, MSM_C, signed=MSM_SIGNED)
            if q == "b_g2":
                out[q].append(MS.bucket_reduce_horner(fops, buckets[None], MSM_C)[0])
            else:
                g1_buckets.append(buckets)
    with span("msm/reduce_g1", dev):
        red = MS.bucket_reduce_horner(W.G1Ops, torch.stack(g1_buckets), MSM_C)
    for q, row in zip(G1_QUERIES, red):
        out[q].append(row)
    return out


def _to_device(host: dict, dev) -> tuple[dict, list]:
    """Copy the host arrays to ``dev`` without waiting: on a card each goes
    through a pinned staging buffer and an asynchronous copy (a copy from
    pageable memory would wait for the work queued before it, the proofs
    still in flight). Returns the device tensors and the staging buffers,
    which the caller keeps until the copies have run."""
    if dev.type != "cuda":
        return {k: torch.as_tensor(v, device=dev) for k, v in host.items()}, []
    staged = {k: torch.from_numpy(v).pin_memory() for k, v in host.items()}
    return {k: t.to(dev, non_blocking=True) for k, t in staged.items()}, list(staged.values())


def _to_host(t):
    """An asynchronous copy of device tensor ``t`` into pinned host memory."""
    if not t.is_cuda:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t, non_blocking=True)


def _fetch_async(parts: dict):
    """Enqueue the device half of the fetch: every result row made affine
    (one batched inversion per group) and copied to host memory. Returns
    the host coordinates per group and, on a card, the event recorded after
    the copies, the one thing the host must wait for."""
    coords = []
    for fops, names, _ in GROUPS:
        rows = torch.stack([r for q in names for r in parts[q]])
        coords.append(tuple(_to_host(c) for c in W.to_affine(fops, unpack_rows(fops.GROUP, rows))))
    event = None
    if rows.is_cuda:
        event = torch.cuda.Event()
        event.record()
    return coords, event


def _sum_parts(coords, n_parts: dict) -> dict:
    """Decode the host coordinates and sum each query's parts."""
    res = {}
    for (_, names, dec), (x, y) in zip(GROUPS, coords):
        pts = dec(x, y)
        i = 0
        for q in names:
            acc = pts[i]
            for p in pts[i + 1 : i + n_parts[q]]:
                acc = acc + p
            i += n_parts[q]
            res[q] = acc
    return res


def _mesh_msms(params: Parameters, mesh, inputs: dict, h_limbs) -> dict:
    """Every MSM of a mesh proof, point-sharded over "msm" with the digits
    extracted on each shard; each result is read from this process's first
    position (the butterfly leaves it on every position)."""
    dev = params.device["dev"]
    out = {}
    for q in G1_QUERIES + ("b_g2",):
        fops = W.G2Ops if q == "b_g2" else W.G1Ops
        with span(f"msm/{q}", dev):
            limbs = h_limbs if q == "h" else inputs[q + "/limbs"]
            point = PM.sharded_sorted_msm(mesh, fops, params.device[q], limbs, MSM_C, axis="msm",
                                          from_limbs=True, signed=MSM_SIGNED)
            out[q] = [point.first]
    return out


def _enqueue(asm: Assembly, params: Parameters, r: int, s: int, device, mesh=None) -> dict:
    """Enqueue one proof on the device, from its inputs' copies to the
    copies of its results, without waiting for the device; ``_drain``
    finishes it. With a mesh: the a/b/c values from the host, the sharded h
    pipeline and the sharded MSMs."""
    if asm.assignment is None:
        raise ValueError("the assembly carries no witness")
    with span("setup"):
        prepare_device_params(params, device, mesh)
        prepare_split_queries(params, asm)
        dev = params.device["dev"]
        st = _structure(params.device, asm)
        m = st["m"]
        if len(params.h) != m - 1:
            raise ValueError(f"h query has {len(params.h)} points, the domain needs {m - 1}")
        dom = params.device.get("domain")
        if dom is None or dom.m != m:
            dom = params.device["domain"] = Domain(m, device=dev)
    if mesh is not None:
        with span("inputs", dev):
            inputs, staged = _host_inputs(params, asm, st, abc_on_device=False), []
        with span("h_pipeline", dev):
            abc = torch.from_numpy(inputs["abc"])
            h_coeffs = PM.sharded_h_pipeline(mesh, dom, abc[0], abc[1], abc[2], axis="msm")
            h_limbs = _h_scalars_sharded(mesh, h_coeffs, m, params.device["h"].shape[0])
        parts = _mesh_msms(params, mesh, inputs, h_limbs)
    else:
        with span("inputs", dev):
            inputs, staged = _to_device(_host_inputs(params, asm, st, ABC_DEVICE), dev)
        with span("h_pipeline", dev):
            h_coeffs = _abc_h(dom, st, inputs["v16"]) if ABC_DEVICE else h_pipeline(dom, inputs["abc"])
            h_limbs = _h_scalar_input(h_coeffs, m, params.device["h"].shape[0])
        parts = _msms(params, inputs, h_limbs)
    with span("fetch", dev):
        coords, event = _fetch_async(parts)
    return {"coords": coords, "event": event, "staged": staged, "r": r, "s": s,
            "n_parts": {q: len(p) for q, p in parts.items()}, "vk": params.vk}


def _drain(pending: dict) -> Proof:
    """Wait for an enqueued proof's results to reach the host (the proof's
    one synchronisation) and assemble it."""
    with span("wait"):
        if pending["event"] is not None:
            pending["event"].synchronize()
    with span("assemble"):
        ans = _sum_parts(pending["coords"], pending["n_parts"])
        vk, r, s = pending["vk"], pending["r"], pending["s"]
        g_a = vk.delta_g1 * r + vk.alpha_g1 + ans["a"]
        g_b = vk.delta_g2 * s + vk.beta_g2 + ans["b_g2"]
        g_c = vk.delta_g1 * (r * s % R) + vk.alpha_g1 * s + vk.beta_g1 * r
        g_c = g_c + ans["h"] + ans["l"] + ans["a"] * s + ans["b_g1"] * r
    return Proof(a=g_a, b=g_b, c=g_c)


def create_proof_from_assembly(asm: Assembly, params: Parameters, r: int, s: int,
                               device="cuda", mesh=None) -> Proof:
    """Groth16 proof of the witness in ``asm`` with randomisers (r, s). With
    a mesh (parallel/mesh.py, with an "msm" axis) the five MSMs run
    point-sharded and every NTT element-sharded over that axis; the proof is
    the same."""
    return _drain(_enqueue(asm, params, r, s, device, mesh))


def create_proofs_from_assemblies(cs_list, params: Parameters, rs_list, device="cuda",
                                  mesh=None) -> list[Proof]:
    """Groth16 proofs of several witnesses of one circuit against one
    Parameters, the i-th with randomisers rs_list[i]. At most
    MASP_BATCH_WINDOW proofs (2 by default) are in flight: proof i is drained
    (its wait and host assembly) only once the window is full, after the
    proofs behind it are enqueued, and the rest at the end. ``cs_list`` may
    be a lazy iterable, so that witness i + 1 is synthesised while proof i
    runs. Every witness must have the parameters' domain (else ValueError).
    ``mesh`` as in create_proof_from_assembly."""
    rs_list = list(rs_list)
    if not rs_list:
        return []
    window = int(os.environ.get("MASP_BATCH_WINDOW", "2"))
    m = len(params.h) + 1
    pending, proofs = [], []
    for asm, (r, s) in zip(cs_list, rs_list):
        if _next_pow2(asm.num_constraints) != m:
            raise ValueError(f"a witness of domain {_next_pow2(asm.num_constraints)} in a batch of "
                             f"domain {m}: one domain per call")
        if len(pending) >= window:
            proofs.append(_drain(pending.pop(0)))
        pending.append(_enqueue(asm, params, r, s, device, mesh))
    while pending:
        proofs.append(_drain(pending.pop(0)))
    return proofs


def synthesize_witness(circuit, use_tape: bool | None = None) -> Assembly:
    """The full assignment of one circuit instance: the native witness tape
    where it can replay the circuit (``use_tape``, by default
    MASP_WITNESS_TAPE, "1" unless set), else the Python gadget walk. The
    route shows in the span it opens, "witness/tape" or "witness/python"."""
    if use_tape is None:
        use_tape = os.environ.get("MASP_WITNESS_TAPE", "1") == "1"
    return S.synthesize_witness(circuit, use_tape)[0]


def create_proof(circuit, params: Parameters, r: int, s: int, device="cuda") -> Proof:
    return create_proof_from_assembly(synthesize_witness(circuit), params, r, s, device)


def create_random_proof(circuit, params: Parameters, rng, device="cuda") -> Proof:
    r = random_scalar(rng).n
    s = random_scalar(rng).n
    return create_proof(circuit, params, r, s, device)


__all__ = [
    "create_proof", "create_random_proof", "create_proof_from_assembly",
    "create_proofs_from_assemblies", "synthesize_witness", "prepare_device_params",
    "prepare_split_queries", "boolean_var_mask", "h_pipeline", "msm_flags", "MSM_C", "MSM_SPLIT",
    "MSM_SPLIT_MIN", "MSM_SIGNED", "ABC_DEVICE",
]
