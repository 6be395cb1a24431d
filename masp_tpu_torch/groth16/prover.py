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
single-device proof byte for byte. The reference's off-by-default routes
run too, each giving the same proof (``msm_flags``): digits from the host
(MASP_MSM_FROM_LIMBS=0), the stacked G1 MSMs (MASP_MSM_STACK=1), the fused
prove (MASP_MSM_FUSED=1), a BGMW table for h (MASP_MSM_BGMW_H=1) and the
lane-private Pippenger (MASP_MSM=lanes); a mesh ignores the stacked, fused
and BGMW routes. A proof is enqueued on the current CUDA stream, its inputs
copied in from pinned host memory, its five query results made affine on the
device and copied out into pinned host memory, all without waiting; then it
is drained: the host waits for its copies and assembles the proof. The batch
prover keeps a window of proofs enqueued ahead of the one it drains.

Departures from the reference that leave every result as it is: the
windows of an MSM run batched (ops/msm_sorted.py), the three a/b/c NTTs run
as one batch, and the bucket reduction of the full-width G1 MSMs runs as
one batch (of four, or three with the BGMW table for h). The reference's
fused route is one XLA program; here it is the same work enqueued in one
pass without waiting, as every route is.
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
from masp_tpu_torch.ops.msm import fr_digits_device, identity_rows, pippenger_msm
from masp_tpu_torch.ops.projective import unpack_rows
from masp_tpu_torch.parallel import mesh as PM
from masp_tpu_torch.utils.tracing import span


def _switch(env, name: str, default: str) -> bool:
    value = env.get(name, default)
    if value not in ("0", "1"):
        raise ValueError(f"{name}={value!r}: the port takes '0' or '1'")
    return value == "1"


def _width(env, name: str, default: str) -> int:
    c = int(env.get(name, default))
    if not 2 <= c <= 16:
        raise ValueError(f"{name}={c}: the window width must be 2 .. 16")
    return c


def msm_flags(env) -> dict:
    """The prover's MSM configuration from the JAX package's variables,
    derived as the reference derives them (masp_tpu/groth16/prover.py:28-95):
    MASP_MSM_C (8), the window width of the full-width MSMs (2 .. 16; on the
    batch-affine ladder only widths whose window count is a power of two);
    MASP_MSM ("sorted": the sorted MSM; "lanes": the lane-private Pippenger
    of ops/msm.py on MSM_LANES_G1 / MSM_LANES_G2 lanes); MASP_MSM_STACK ("1":
    the four G1 MSMs as one ``sorted_msm_batch`` over a shared padding);
    MASP_MSM_FROM_LIMBS ("1": digits extracted on the device from limb rows;
    "0": digits from the host), in force only for the sorted MSM unstacked;
    MASP_MSM_SIGNED ("1": balanced signed digits), only with FROM_LIMBS;
    MASP_MSM_SPLIT ("1") and MASP_MSM_SPLIT_MIN (32768), the boolean split of
    the l/a/b queries and the bit wires a query needs for it (Spend: 50-68k
    per query; Output and Convert: 17-24k), only for the sorted MSM
    unstacked; MASP_MSM_FUSED ("1": the whole proof enqueued at once, the
    a/b/c values from the host, split halves summed on the device, 5 points
    fetched), only with FROM_LIMBS; MASP_MSM_BGMW_H ("1": the h query over a
    fixed-base table) at MASP_MSM_BGMW_C (12; 2 .. 16), only for the sorted
    MSM with FROM_LIMBS; MASP_ABC_DEVICE ("1": the a/b/c values on the
    device; "0": on the host, through the native evaluator). A value the port
    does not take raises ValueError: a switch other than "0" or "1", MASP_MSM
    other than sorted or lanes (the reference runs any other as lanes), a
    width out of range, and digits from the host (FROM_LIMBS off in effect)
    at a width other than 4 or 8. MASP_MSM_VMAP_WINDOWS (how XLA batches the
    windows) and the pairing's MASP_PAIR_MILLER_CHUNK and
    MASP_PAIR_EXP_CHUNK (how long one XLA program is) have no effect in the
    port: it runs every window in one batch and the pairing as it goes."""
    c = _width(env, "MASP_MSM_C", "8")
    impl = env.get("MASP_MSM", "sorted")
    if impl not in ("sorted", "lanes"):
        raise ValueError(f"MASP_MSM={impl!r}: the port takes 'sorted' or 'lanes'")
    stack = _switch(env, "MASP_MSM_STACK", "0")
    from_limbs = _switch(env, "MASP_MSM_FROM_LIMBS", "1") and impl == "sorted" and not stack
    signed = _switch(env, "MASP_MSM_SIGNED", "0") and from_limbs
    split = _switch(env, "MASP_MSM_SPLIT", "1") and impl == "sorted" and not stack
    fused = _switch(env, "MASP_MSM_FUSED", "0") and from_limbs
    bgmw_h = _switch(env, "MASP_MSM_BGMW_H", "0") and impl == "sorted" and from_limbs
    bgmw_c = _width(env, "MASP_MSM_BGMW_C", "12")
    abc_device = _switch(env, "MASP_ABC_DEVICE", "1")
    if not from_limbs and c not in (4, 8):
        raise ValueError(f"MASP_MSM_C={c}: digits from the host (MASP_MSM_FROM_LIMBS=0, MASP_MSM_STACK=1 or "
                         f"MASP_MSM=lanes) take c = 4 or 8")
    n_windows = MS.n_windows_for(c, signed)
    if MS.AFFINE_LADDER and not MS.affine_ladder_takes(n_windows, 1):
        raise ValueError(f"MASP_MSM_C={c}: {n_windows} windows, which the batch-affine ladder "
                         f"cannot take (a power-of-two count is needed)")
    return {"MSM_C": c, "MSM_IMPL": impl, "MSM_STACK": stack, "MSM_FROM_LIMBS": from_limbs,
            "MSM_SIGNED": signed, "MSM_SPLIT": split, "MSM_SPLIT_MIN": int(env.get("MASP_MSM_SPLIT_MIN", "32768")),
            "MSM_FUSED": fused, "MSM_BGMW_H": bgmw_h, "MSM_BGMW_C": bgmw_c, "ABC_DEVICE": abc_device}


_FLAGS = msm_flags(os.environ)
# window width of the full-width MSMs
MSM_C = _FLAGS["MSM_C"]
# "sorted": the sorted MSM (ops/msm_sorted.py); "lanes": the lane-private
# Pippenger (ops/msm.py) on 64 lanes in G1 and 32 in G2
MSM_IMPL = _FLAGS["MSM_IMPL"]
MSM_LANES_G1 = 64
MSM_LANES_G2 = 32
# the four G1 MSMs as one sorted_msm_batch over a (4, N) stack
MSM_STACK = _FLAGS["MSM_STACK"]
# digits extracted on the device from the scalars' limb rows (else the host's)
MSM_FROM_LIMBS = _FLAGS["MSM_FROM_LIMBS"]
# balanced signed digits in every full-width MSM
MSM_SIGNED = _FLAGS["MSM_SIGNED"]
# whether a query is split into a {0,1}-scalar part and a full-width part,
# and from how many structural bit wires
MSM_SPLIT = _FLAGS["MSM_SPLIT"]
MSM_SPLIT_MIN = _FLAGS["MSM_SPLIT_MIN"]
# the whole proof enqueued at once: a/b/c from the host, 5 points fetched
MSM_FUSED = _FLAGS["MSM_FUSED"]
# the h query through a BGMW table of window width MSM_BGMW_C
MSM_BGMW_H = _FLAGS["MSM_BGMW_H"]
MSM_BGMW_C = _FLAGS["MSM_BGMW_C"]
# the a/b/c values on the device (else on the host; always so with a mesh
# and in the fused route)
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
    return _pad_rows(rows, 1 << max(floor_log2, (max(rows.shape[0], 1) - 1).bit_length()), g2)


def _pad_to(n: int, mult: int) -> int:
    return n + ((-n) % mult)


def _pad_rows(rows: np.ndarray, n: int, g2: bool) -> np.ndarray:
    """Packed rows padded with identities to n rows."""
    out = np.tile(_identity_row(g2), (n, 1))
    out[: rows.shape[0]] = rows
    return out


def _encode_padded(rows: np.ndarray, n: int, g2: bool, dev):
    """A query on ``dev`` in the lanes layout: padded with identities to n
    rows, as the (X, Y, Z) coordinates ``pippenger_msm`` takes (views of
    one packed tensor)."""
    return unpack_rows(2 if g2 else 1, torch.as_tensor(_pad_rows(rows, n, g2), device=dev))


def _dev_n(points_dev) -> int:
    """Padded point count of a device query in any layout: packed rows,
    sharded rows or (X, Y, Z) coordinates."""
    return points_dev[0].shape[0] if isinstance(points_dev, tuple) else points_dev.shape[0]


def _layout(mesh) -> str:
    """The device layout of the queries: "sorted" (each query padded to its
    own power of two; always so with a mesh, which ignores the other
    routes), "stacked" (the four G1 queries in one (4, N) stack at a shared
    power of two) or "lanes" (coordinates at a shared multiple of the
    lanes)."""
    if mesh is not None:
        return "sorted"
    return "lanes" if MSM_IMPL == "lanes" else "stacked" if MSM_STACK else "sorted"


def prepare_device_params(params: Parameters, device, mesh=None) -> None:
    """Copy every query to the device once. In the sorted layout each query
    is packed rows padded with identities to its own power of two (the
    padding changes no result); with a mesh each pads to at least the "msm"
    axis's size and is placed sharded over that axis (``device`` is not
    read: the mesh names the devices). The stacked layout holds the four G1
    queries as one (4, N, 72) ``g1_stack`` at their shared power of two N,
    with no per-query pads, and b_g2 at its own; the lanes layout holds the
    G1 queries at one shared multiple of MSM_LANES_G1 and b_g2 at a multiple
    of MSM_LANES_G2, as coordinates. The cache is keyed by the device, the
    mesh and the layout, and rebuilt when any of them changes, so that a
    route never reads another route's rows. With MSM_BGMW_H (no mesh) the h
    query's BGMW table is built once too."""
    key = None if mesh is None else mesh.key
    dev = resolve_device(device) if mesh is None else mesh.device(mesh.local_positions()[0])
    layout = _layout(mesh)
    cache = params.device
    if (cache.get("dev"), cache.get("mesh"), cache.get("layout")) != (dev, key, layout):
        cache.clear()
        cache.update(dev=dev, mesh=key, layout=layout)
        n_max = max(params.rows(q).shape[0] for q in G1_QUERIES)
        if layout == "stacked":
            n = cache["n_g1"] = _next_pow2(n_max)
            cache["g1_stack"] = torch.as_tensor(np.stack([_pad_rows(params.rows(q), n, False) for q in G1_QUERIES]),
                                                device=dev)
            cache["b_g2"] = torch.as_tensor(_pad_pow2(params.rows("b_g2"), True), device=dev)
        elif layout == "lanes":
            n = cache["n_g1"] = _pad_to(n_max, MSM_LANES_G1)
            for q in G1_QUERIES:
                cache[q] = _encode_padded(params.rows(q), n, False, dev)
            b_g2 = params.rows("b_g2")
            cache["b_g2"] = _encode_padded(b_g2, _pad_to(b_g2.shape[0], MSM_LANES_G2), True, dev)
        else:
            for q in G1_QUERIES + ("b_g2",):
                if mesh is None:
                    cache[q] = torch.as_tensor(_pad_pow2(params.rows(q), q == "b_g2"), device=dev)
                else:
                    rows = _pad_pow2(params.rows(q), q == "b_g2", (mesh.shape["msm"] - 1).bit_length())
                    cache[q] = PM.shard(mesh, rows, "msm")
    if MSM_BGMW_H and layout == "sorted" and mesh is None:
        _prepare_bgmw_h(params)


def _prepare_bgmw_h(params: Parameters) -> None:
    """Build the h query's BGMW table at MSM_BGMW_C on the device, once per
    parameters, device and width (span "bgmw_table")."""
    cache = params.device
    if cache.get("h_bgmw_c") == MSM_BGMW_C:
        return
    with span("bgmw_table", cache["dev"]):
        cache["h_bgmw"] = MS.build_bgmw_table(W.G1Ops, cache["h"], MSM_BGMW_C)
    cache["h_bgmw_c"] = MSM_BGMW_C


def prepare_split_queries(params: Parameters, asm: Assembly) -> None:
    """Split l/a/b_g1/b_g2 into a {0,1}-scalar part and a full-width part by
    the structural boolean mask, where at least MSM_SPLIT_MIN exponents of a
    query are bit wires (and not all of them). Witness values are checked
    against the mask at prove time. Nothing is split for a mesh, whose five
    queries go whole through the sharded MSM, nor in the stacked and lanes
    layouts, as the reference splits only for the sorted MSM unstacked."""
    if params.device.get("mesh") is not None or params.device.get("layout") != "sorted":
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


def _h_digits_device(h_bytes):
    """(n, 32) device byte digits -> (n, 256 / c) c-bit digits, c = 8 or 4."""
    if MSM_C == 8:
        return h_bytes
    return torch.stack([h_bytes & 0xF, h_bytes >> 4], dim=-1).reshape(h_bytes.shape[0], 64)


def _h_scalars(h_mont):
    """The h scalars of Montgomery coefficients, on their device: canonical
    limb rows (digits extracted in the MSM) or, with the host-digit layout,
    c-bit digits from the device's byte digits (``fr_digits_device``)."""
    if MSM_FROM_LIMBS:
        return F.from_mont(FR, h_mont)
    return _h_digits_device(fr_digits_device(h_mont))


def _h_scalar_input(h_coeffs, m: int, n_g1: int):
    """h scalars for the MSM, zero-padded to n_g1 (bellman drops the last
    coefficient: degree <= m - 2)."""
    h = _h_scalars(h_coeffs[: m - 1])
    out = torch.zeros((n_g1, h.shape[1]), dtype=h.dtype, device=h.device)
    out[: m - 1] = h
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
        out = _h_scalars(v)
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


def _digits_from_u64(arr: np.ndarray, n_padded: int) -> np.ndarray:
    """(n, 4) uint64 little-endian scalars -> (n_padded, 256 / c) int32
    c-bit digits on the host, c = MSM_C = 8 (the bytes) or 4 (nibbles)."""
    n = arr.shape[0]
    b = np.ascontiguousarray(arr).view(np.uint8).reshape(n, 32)
    if MSM_C == 8:
        out = np.zeros((n_padded, 32), dtype=np.int32)
        out[:n] = b
        return out
    if MSM_C != 4:
        raise ValueError(f"host digits take c = 4 or 8, not {MSM_C}")
    out = np.zeros((n_padded, 64), dtype=np.int32)
    out[:n, 0::2] = b & 0xF
    out[:n, 1::2] = b >> 4
    return out


def _scalar_input(arr: np.ndarray, n_padded: int) -> np.ndarray:
    """A query's scalars in the active layout: limb rows (digits extracted
    on the device) or the host's digits."""
    return _limbs(arr, n_padded) if MSM_FROM_LIMBS else _digits_from_u64(arr, n_padded)


def _query_n(cache: dict, q: str) -> int:
    """Rows of query q on the device (the shared N in the stacked layout)."""
    return cache["n_g1"] if cache["layout"] == "stacked" and q != "b_g2" else _dev_n(cache[q])


def _host_inputs(params: Parameters, asm: Assembly, st: dict, abc_on_device: bool) -> dict:
    """Every per-proof array the device needs, built on the host: the
    witness limb rows (``abc_on_device``) or the a/b/c values, and per query
    the full-width scalars (``_scalar_input``) and, when split, the bit
    column. Raises if a witness value violates the boolean split."""
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
            out[q + "/scalars"] = _scalar_input(arr, _query_n(dev, q))
            continue
        qm = dev[q + "_qmask"]
        small, full = arr[qm], arr[~qm]
        if small.size and (small[:, 1:].any() or (small[:, 0] > 1).any()):
            raise ValueError(f"boolean-split mask violated by witness for query {q!r}")
        bits = np.zeros(dev[q + "_small"].shape[0], dtype=np.int32)
        bits[: small.shape[0]] = small[:, 0]
        out[q + "/bits"] = bits
        out[q + "/scalars"] = _scalar_input(full, dev[q + "_full"].shape[0])
    return out


def _digits(scalars):
    """Window digits of a query's scalars: extracted on the device from limb
    rows, or the host's digits as they are."""
    return MS.windows_from_limbs(scalars, MSM_C, MSM_SIGNED) if MSM_FROM_LIMBS else scalars


def _msms(params: Parameters, inputs: dict, h_scalars, bgmw: bool = True):
    """Enqueue every MSM in the parameters' layout; returns {query:
    [projective rows]} (one row per part) without synchronising. Sorted
    layout: per query the sorted MSM's windows, the h query through its BGMW
    table with MSM_BGMW_H (and ``bgmw``), and one bucket reduction over
    the full-width G1 MSMs. Stacked: the four G1 MSMs as one
    ``sorted_msm_batch``, b_g2 behind it. Lanes: ``pippenger_msm`` a query."""
    cache = params.device
    dev = cache["dev"]
    out = {q: [] for q in G1_QUERIES + ("b_g2",)}
    scalars = {"h": h_scalars, **{q: inputs[q + "/scalars"] for q in G1_QUERIES[1:] + ("b_g2",)}}
    if cache["layout"] == "lanes":
        for q in G1_QUERIES + ("b_g2",):
            fops = W.G2Ops if q == "b_g2" else W.G1Ops
            lanes = MSM_LANES_G2 if q == "b_g2" else MSM_LANES_G1
            with span(f"msm/{q}", dev):
                xyz = pippenger_msm(fops, cache[q], scalars[q], MSM_C, lanes=lanes)
                out[q].append(torch.cat([x.reshape(-1) for x in xyz]))
        return out
    if cache["layout"] == "stacked":
        with span("msm/g1_stack", dev):
            digits = torch.stack([scalars[q] for q in G1_QUERIES])
            for q, row in zip(G1_QUERIES, MS.sorted_msm_batch(W.G1Ops, cache["g1_stack"], digits, MSM_C)):
                out[q].append(row)
        with span("msm/b_g2", dev):
            out["b_g2"].append(MS.sorted_msm(W.G2Ops, cache["b_g2"], scalars["b_g2"], MSM_C))
        return out
    g1_buckets = {}
    for q in G1_QUERIES + ("b_g2",):
        fops = W.G2Ops if q == "b_g2" else W.G1Ops
        with span(f"msm/{q}", dev):
            if q == "h":
                if bgmw and MSM_BGMW_H:
                    out[q].append(MS.bgmw_msm_from_limbs(fops, cache["h_bgmw"], h_scalars, MSM_BGMW_C))
                    continue
                pts = cache["h"]
            elif q + "/bits" in inputs:
                out[q].append(MS.masked_sum(fops, cache[q + "_small"], inputs[q + "/bits"]))
                pts = cache[q + "_full"]
            else:
                pts = cache[q]
            buckets = MS.window_buckets(fops, pts, _digits(scalars[q]), MSM_C, signed=MSM_SIGNED)
            if q == "b_g2":
                out[q].append(MS.bucket_reduce_horner(fops, buckets[None], MSM_C)[0])
            else:
                g1_buckets[q] = buckets
    with span("msm/reduce_g1", dev):
        red = MS.bucket_reduce_horner(W.G1Ops, torch.stack(list(g1_buckets.values())), MSM_C)
    for q, row in zip(g1_buckets, red):
        out[q].append(row)
    return out


def _fused_msms(params: Parameters, inputs: dict, h_scalars) -> dict:
    """The fused route's MSMs (the reference's ``_fused_prove_async``, which
    runs no BGMW table): every MSM as ``_msms`` enqueues it, and each split
    query's two halves summed on the device by one point add, so that the
    fetch copies out exactly 5 points."""
    parts = _msms(params, inputs, h_scalars, bgmw=False)
    with span("msm/combine", params.device["dev"]):
        for q, rows in parts.items():
            if len(rows) == 2:
                fops = W.G2Ops if q == "b_g2" else W.G1Ops
                parts[q] = [MS._add(fops, rows[0][None], rows[1][None])[0]]
    return parts


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


def _mesh_msms(params: Parameters, mesh, inputs: dict, h_scalars) -> dict:
    """Every MSM of a mesh proof, point-sharded over "msm" with the digits
    extracted on each shard (or the host's digits, MSM_FROM_LIMBS off); each
    result is read from this process's first position (the butterfly leaves
    it on every position)."""
    dev = params.device["dev"]
    out = {}
    for q in G1_QUERIES + ("b_g2",):
        fops = W.G2Ops if q == "b_g2" else W.G1Ops
        with span(f"msm/{q}", dev):
            scalars = h_scalars if q == "h" else inputs[q + "/scalars"]
            point = PM.sharded_sorted_msm(mesh, fops, params.device[q], scalars, MSM_C, axis="msm",
                                          from_limbs=MSM_FROM_LIMBS, signed=MSM_SIGNED)
            out[q] = [point.first]
    return out


def _enqueue(asm: Assembly, params: Parameters, r: int, s: int, device, mesh=None) -> dict:
    """Enqueue one proof on the device, from its inputs' copies to the
    copies of its results, without waiting for the device; ``_drain``
    finishes it. With a mesh: the a/b/c values from the host, the sharded h
    pipeline and the sharded MSMs. With MSM_FUSED (no mesh): the a/b/c
    values from the host, the h pipeline and its scalars, every MSM and the
    sum of the split halves, and the fetch of 5 points, enqueued as one
    stream of work."""
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
        fused = MSM_FUSED and params.device["layout"] == "sorted" and mesh is None
    if mesh is not None:
        with span("inputs", dev):
            inputs, staged = _host_inputs(params, asm, st, abc_on_device=False), []
        with span("h_pipeline", dev):
            abc = torch.from_numpy(inputs["abc"])
            h_coeffs = PM.sharded_h_pipeline(mesh, dom, abc[0], abc[1], abc[2], axis="msm")
            h_scalars = _h_scalars_sharded(mesh, h_coeffs, m, params.device["h"].shape[0])
        parts = _mesh_msms(params, mesh, inputs, h_scalars)
    else:
        abc_on_device = ABC_DEVICE and not fused
        with span("inputs", dev):
            inputs, staged = _to_device(_host_inputs(params, asm, st, abc_on_device), dev)
        with span("h_pipeline", dev):
            h_coeffs = _abc_h(dom, st, inputs["v16"]) if abc_on_device else h_pipeline(dom, inputs["abc"])
            h_scalars = _h_scalar_input(h_coeffs, m, _query_n(params.device, "h"))
        parts = (_fused_msms if fused else _msms)(params, inputs, h_scalars)
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
    ``mesh`` as in create_proof_from_assembly. Each proof takes the single
    prover's route (fused, BGMW for h, lanes, host digits); the stacked
    layout raises ValueError, as the reference asserts."""
    if _layout(mesh) == "stacked":
        raise ValueError("batch proving uses the per-query device layout, not the stacked one (MSM_STACK)")
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
    "prepare_split_queries", "boolean_var_mask", "h_pipeline", "msm_flags", "MSM_C", "MSM_IMPL",
    "MSM_LANES_G1", "MSM_LANES_G2", "MSM_STACK", "MSM_FROM_LIMBS", "MSM_SPLIT", "MSM_SPLIT_MIN",
    "MSM_SIGNED", "MSM_FUSED", "MSM_BGMW_H", "MSM_BGMW_C", "ABC_DEVICE",
]
