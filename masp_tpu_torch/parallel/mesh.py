"""Multi-device sharding for the proving pipeline.

A rewrite (not a copy) of masp_tpu/parallel/mesh.py on torch devices, with
its names and its arithmetic. The reference's ``jax.sharding.Mesh`` and
``shard_map`` become three things here:

* ``Mesh``: named axes over positions, each position a ``torch.device`` held
  by one process (its rank). A mesh may name one device at several positions
  (a virtual mesh, ``make_mesh(4, devices=[cuda] * 4)``), as the reference's
  tests run on a virtual 8-device CPU mesh; it does so only where the caller
  lists the device that way.
* ``Sharded``: a tensor laid out over a mesh, split along dim 0 into one
  chunk per coordinate of ``axis`` (chunk i on every position whose ``axis``
  coordinate is i, so a ``P("msm")`` input is held, and computed on, by
  every row of the other axes, as the reference does), or replicated on
  every position (``axis`` None). It holds this process's positions only.
  ``shard`` splits a whole tensor onto the mesh, ``gather`` joins one back.
* collectives between positions: ``ppermute`` and ``all_gather``. Between
  positions of one process a chunk moves by a device-to-device copy (always
  a copy, also onto the same device); between processes by
  ``torch.distributed`` point-to-point operations (``parallel/distributed.py``
  starts the runtime). Nothing goes through the host on the single-process
  route.

Every position runs its own work on its own device (``smap``), so a mesh of
D positions launches D times the kernels of one device at 1/D of the width.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from masp_tpu_torch import device_const, resolve_device
from masp_tpu_torch.groth16.domain import Domain
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops import msm as M
from masp_tpu_torch.ops import msm_sorted as MS
from masp_tpu_torch.ops.field import FR


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """Named axes over positions: ``devices`` is an ndarray of torch.device
    shaped by the axes (row-major), ``ranks`` the process that holds each
    position, ``process_index`` this process's rank. ``shape`` is the
    {axis: size} dict the prover reads (``mesh.shape["msm"]``)."""

    def __init__(self, devices, axis_names, ranks=None, process_index: int | None = None):
        arr = np.empty(np.shape(devices), dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = torch.device(np.asarray(devices, dtype=object)[idx])
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"{arr.ndim}-dimensional devices for axes {self.axis_names}")
        self.devices = arr
        self.process_index = _rank() if process_index is None else process_index
        self.ranks = (np.full(arr.shape, self.process_index, dtype=np.int64) if ranks is None
                      else np.asarray(ranks, dtype=np.int64).reshape(arr.shape))
        for p in self.local_positions():  # "cuda" names the current card, as a tensor's device does
            dev = resolve_device(self.device(p))
            if dev.type == "cuda" and dev.index is None:
                self.devices.flat[p] = torch.device("cuda", torch.cuda.current_device())

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def key(self) -> tuple:
        """What identifies the layout: axes, devices and ranks."""
        return (self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat),
                tuple(int(r) for r in self.ranks.flat))

    def local_positions(self) -> list[int]:
        """This process's positions, as flat row-major indices."""
        return [p for p in range(self.size) if self.ranks.flat[p] == self.process_index]

    def device(self, p: int) -> torch.device:
        return self.devices.flat[p]

    def rank(self, p: int) -> int:
        return int(self.ranks.flat[p])

    def axis_index(self, p: int, axis: str) -> int:
        return int(np.unravel_index(p, self.devices.shape)[self.axis_names.index(axis)])

    def group(self, p: int, axis: str) -> list[int]:
        """The positions that differ from p only along ``axis``, in the
        order of their ``axis`` coordinate."""
        coords = list(np.unravel_index(p, self.devices.shape))
        k = self.axis_names.index(axis)
        out = []
        for i in range(self.devices.shape[k]):
            coords[k] = i
            out.append(int(np.ravel_multi_index(coords, self.devices.shape)))
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: int | None = None, axis: str = "msm", devices=None) -> Mesh:
    """A one-axis mesh of this process. Without ``devices``, the first
    ``n_devices`` (default: all) visible CUDA devices; raises when fewer are
    present. With ``devices``, its first ``n_devices`` entries (all by
    default), which may repeat a device: ``[torch.device("cuda")] * 4`` is
    a virtual 4-position mesh on one card, ``["cpu"] * 4`` one on the CPU."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = count if n_devices is None else n_devices
        if n < 1 or count < n:
            raise RuntimeError(f"make_mesh({n_devices}): {count} CUDA devices visible; a virtual mesh is "
                               f"asked for with devices=[torch.device('cuda')] * n")
        devices = [torch.device("cuda", i) for i in range(n)]
    else:
        devices = list(devices)
        n = len(devices) if n_devices is None else n_devices
        if n < 1 or len(devices) < n:
            raise ValueError(f"make_mesh({n_devices}): {len(devices)} devices given")
        devices = devices[:n]
    return Mesh(np.asarray([torch.device(d) for d in devices], dtype=object), (axis,))


# --- sharded tensors ------------------------------------------------------------

def _on(dev: torch.device):
    """The device's context for a position's work: kernels launch on the
    current stream of the current CUDA device."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _copy(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A copy of t on dev, enqueued without waiting; always a copy, also
    where t is on dev already."""
    out = torch.empty(t.shape, dtype=t.dtype, device=dev)
    return out.copy_(t, non_blocking=True)


class Sharded:
    """A global tensor of ``shape`` over ``mesh``: split along dim 0 into
    mesh.shape[axis] chunks, chunk i on every position whose ``axis``
    coordinate is i, or replicated (``axis`` None). ``shards`` maps each of
    this process's positions to its tensor on the position's device."""

    def __init__(self, mesh: Mesh, axis: str | None, shards: dict, shape: tuple):
        self.mesh, self.axis, self.shards, self.shape = mesh, axis, shards, tuple(shape)

    @property
    def first(self) -> torch.Tensor:
        """This process's first position's tensor."""
        return self.shards[self.mesh.local_positions()[0]]

    def __repr__(self) -> str:
        return f"Sharded({self.shape}, axis={self.axis!r}, {self.mesh!r})"


class Placement:
    """Where ``shard`` puts a tensor: split along ``axis`` of ``mesh``, or
    replicated for axis None (the reference's NamedSharding)."""

    def __init__(self, mesh: Mesh, axis: str | None):
        self.mesh, self.axis = mesh, axis

    def put(self, x) -> Sharded:
        return shard(self.mesh, x, self.axis)


def shard(mesh: Mesh, x, axis: str | None = None) -> Sharded:
    """Split a whole tensor (or numpy array) onto the mesh along dim 0 by
    ``axis``, or replicate it (axis None): each of this process's positions
    gets a copy of its chunk on its device. Every process passes the same
    whole tensor."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    n_chunks = 1 if axis is None else mesh.shape[axis]
    if x.shape[0] % n_chunks:
        raise ValueError(f"{x.shape[0]} rows do not split into {n_chunks} chunks along {axis!r}")
    C = x.shape[0] // n_chunks
    shards = {}
    for p in mesh.local_positions():
        i = 0 if axis is None else mesh.axis_index(p, axis)
        shards[p] = _copy(x[i * C : (i + 1) * C], mesh.device(p))
    return Sharded(mesh, axis, shards, x.shape)


def smap(fn, *args, axis: str | None) -> Sharded:
    """fn(p, *local_args) on every position p of this process, on its
    device; a Sharded argument gives its position's tensor, anything else is
    passed as it is. The results make a Sharded along ``axis`` (None: the
    same value on every position)."""
    mesh = next(a.mesh for a in args if isinstance(a, Sharded))
    shards = {}
    for p in mesh.local_positions():
        with _on(mesh.device(p)):
            shards[p] = fn(p, *[a.shards[p] if isinstance(a, Sharded) else a for a in args])
    like = next(iter(shards.values()))
    n = 1 if axis is None else mesh.shape[axis]
    return Sharded(mesh, axis, shards, (like.shape[0] * n,) + tuple(like.shape[1:]) if like.dim() else ())


def _exchange(sh: Sharded, axis: str, route) -> dict:
    """Chunks between positions along ``axis``: route(dst) gives, for a
    destination position dst (any process's), the list of the group's
    coordinates whose tensors dst receives, in order. Returns, for each of
    this process's destinations, the received tensors in that order: a
    device copy where the source is local, a point-to-point receive where
    it is another process's (every process walks the same global list, so
    the sends and receives pair up)."""
    mesh = sh.mesh
    me = mesh.process_index
    out = {p: [] for p in mesh.local_positions()}
    ops = []
    for dst in range(mesh.size):
        grp = mesh.group(dst, axis)
        for k, i in enumerate(route(dst)):
            src = grp[i]
            if mesh.rank(dst) == me and mesh.rank(src) == me:
                out[dst].append(_copy(sh.shards[src], mesh.device(dst)))
                continue
            if me not in (mesh.rank(src), mesh.rank(dst)):
                continue
            import torch.distributed as dist

            tag = dst * mesh.size + k
            if mesh.rank(src) == me:
                ops.append(dist.P2POp(dist.isend, sh.shards[src].contiguous(), mesh.rank(dst), tag=tag))
            else:
                buf = torch.empty_like(sh.shards[dst])
                ops.append(dist.P2POp(dist.irecv, buf, mesh.rank(src), tag=tag))
                out[dst].append(buf)
    if ops:
        import torch.distributed as dist

        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def ppermute(sh: Sharded, axis: str, pairs) -> Sharded:
    """Each position gets the tensor of its partner along ``axis``:
    ``pairs`` lists (source, destination) coordinates, as
    jax.lax.ppermute's do; a destination no pair names gets zeros."""
    src_of = {d: s for s, d in pairs}
    mesh = sh.mesh
    got = _exchange(sh, axis, lambda dst: [src_of[c]] if (c := mesh.axis_index(dst, axis)) in src_of else [])
    shards = {p: (v[0] if v else torch.zeros_like(sh.shards[p])) for p, v in got.items()}
    return Sharded(mesh, sh.axis, shards, sh.shape)


def all_gather(sh: Sharded, axis: str | None = None) -> Sharded:
    """Every position gets the chunks of its group along ``axis`` (by
    default the tensor's own) joined along dim 0, in coordinate order: the
    whole tensor, replicated."""
    axis = axis or sh.axis
    if axis is None:
        return sh
    mesh = sh.mesh
    n = mesh.shape[axis]
    got = _exchange(sh, axis, lambda dst: list(range(n)))
    shards = {p: torch.cat(v, dim=0) for p, v in got.items()}
    like = next(iter(shards.values()))
    return Sharded(mesh, None, shards, like.shape)


def gather(sh: Sharded, device=None) -> torch.Tensor:
    """The whole tensor on ``device`` (default: this process's first
    position's device): a replicated tensor's first local copy, or the
    chunks joined. Each process receives the chunks its first position
    lacks, so every process calls it."""
    mesh = sh.mesh
    if sh.axis is not None:
        firsts = {min(p for p in range(mesh.size) if mesh.rank(p) == r) for r in set(mesh.ranks.flat)}
        n = mesh.shape[sh.axis]
        got = _exchange(sh, sh.axis, lambda dst: list(range(n)) if dst in firsts else [])
        out = torch.cat(got[mesh.local_positions()[0]], dim=0)
    else:
        out = sh.first
    return out if device is None else out.to(device)


def as_sharded(mesh: Mesh, x, axis: str | None) -> Sharded:
    """x laid out along ``axis`` (None: replicated): a whole tensor is
    split, a replicated Sharded sliced where it lies, one sharded along
    another axis gathered first."""
    if not isinstance(x, Sharded):
        return shard(mesh, x, axis)
    if x.axis == axis:
        return x
    if x.axis is not None:
        x = all_gather(x)
    if axis is None:
        return x
    C = x.shape[0] // mesh.shape[axis]
    return smap(lambda p, v: v[mesh.axis_index(p, axis) * C : (mesh.axis_index(p, axis) + 1) * C], x, axis=axis)


# --- the sharded functions --------------------------------------------------------

def _domain_on(dom: Domain, dev: torch.device) -> Domain:
    """The domain with its tables on ``dev`` (built once per device)."""
    if dom.device == dev:
        return dom
    return device_const(("domain", dom.m, dev), lambda: Domain(dom.m, device=dev))


def sharded_pippenger(mesh: Mesh, fops, points_xyz, digits, c: int, lanes: int, axis: str = "msm") -> Sharded:
    """MSM with the point axis sharded over ``axis``: each position runs
    ``ops.msm.pippenger_msm`` on its shard, the partial sums (one point a
    position) are all-gathered and combined in shard order.

    points_xyz: the (X, Y, Z) coordinate tensors (N, ...), N divisible by
    the axis size times lanes; digits (N, W). Returns the point as a
    replicated packed row (rowlen,)."""
    n_shards = mesh.shape[axis]
    pts = tuple(as_sharded(mesh, x, axis) for x in points_xyz)

    def local(p, px, py, pz, d):
        out = M.pippenger_msm(fops, (px, py, pz), d, c, lanes)
        return torch.cat([x.reshape(-1) for x in out])[None]

    partials = all_gather(smap(local, *pts, as_sharded(mesh, digits, axis), axis=axis))

    def combine(p, rows):
        acc = M.identity_rows(fops, (1,), rows.device)
        for i in range(n_shards):
            acc = MS._add(fops, acc, rows[i : i + 1])
        return acc[0]

    return smap(combine, partials, axis=None)


def sharded_ntt(mesh: Mesh, dom: Domain, x, axis: str = "ntt", inverse: bool = False) -> Sharded:
    """Size-m NTT with the element axis sharded over ``axis`` (D positions).

    Distributed DIT radix-2: after the bit-reversal permutation (an
    all-gather, then each position takes its chunk) the array is held in
    contiguous chunks of C = m / D elements. Stages with half = 2^s < C pair
    elements inside a chunk; the last log2(D) stages pair chunk d with chunk
    d XOR (half / C), one ``ppermute`` a stage, each position computing its
    own half of the butterfly: it keeps E + wO if d has that bit clear, else
    E - wO, with the twiddle run starting at (d C) mod half. Then m^-1 when
    ``inverse``. The same products as Domain.fft; the same limbs.

    x: (m, 16) Montgomery limbs, whole or Sharded. Returns a Sharded along
    ``axis``."""
    D = mesh.shape[axis]
    m, log_m = dom.m, dom.log_m
    C = m // D
    if C * D != m or C & (C - 1):
        raise ValueError(f"m = {m} must be {D} times a power of two")
    log_c = C.bit_length() - 1

    def start(p, xf):
        d = mesh.axis_index(p, axis)
        dm = _domain_on(dom, xf.device)
        xc = xf[dm._bitrev()[d * C : (d + 1) * C]]
        tws = dm._twiddles(inverse)
        for s in range(min(log_c, log_m)):  # the butterfly groups inside the chunk
            half = 1 << s
            xr = xc.reshape(C // (2 * half), 2, half, FR.L)
            even, odd = xr[:, 0], F.mont_mul(FR, xr[:, 1], tws[s][None])
            xc = torch.stack([F.add(FR, even, odd), F.sub(FR, even, odd)], dim=1).reshape(C, FR.L)
        return xc

    xc = smap(start, as_sharded(mesh, x, None), axis=axis)
    for s in range(log_c, log_m):  # the chunk exchanges
        half = 1 << s
        bit = half // C  # partner distance in chunks
        yc = ppermute(xc, axis, [(i, i ^ bit) for i in range(D)])

        def stage(p, xl, yl, half=half, bit=bit, s=s):
            d = mesh.axis_index(p, axis)
            even = (d & bit) == 0
            j0 = (d * C) % half
            tw = _domain_on(dom, xl.device)._twiddles(inverse)[s][j0 : j0 + C]
            E, O = (xl, yl) if even else (yl, xl)
            wO = F.mont_mul(FR, O, tw)
            return F.add(FR, E, wO) if even else F.sub(FR, E, wO)

        xc = smap(stage, xc, yc, axis=axis)
    if inverse:
        xc = smap(lambda p, v: F.mont_mul(FR, v, _domain_on(dom, v.device)._scalar(dom.m_inv)[None, :]),
                  xc, axis=axis)
    return xc


def sharded_sorted_msm(mesh: Mesh, fops, points_packed, digits, c: int, axis: str = "msm",
                       from_limbs: bool = False, signed: bool = False) -> Sharded:
    """Sorted-prefix MSM (ops/msm_sorted.py) with the point axis sharded.

    Each position computes the bucket sums of its own point shard
    (``window_buckets``: local sort and prefix ladder); the (W, B) bucket
    states are then all-reduced across the axis by a log2(D)-stage butterfly
    of group adds (stage s: each position adds its partner's state at
    distance 2^s; the complete add is symmetric in its operands, so both
    partners hold the same limbs after each stage), and the bucket-weighted
    Horner reduction runs on every position.

    points_packed: (N, rowlen) packed rows, N divisible by the axis size,
    whole or Sharded; digits: (N, W) window digits, or with ``from_limbs``
    (N, 16) canonical 16-bit limb rows, the digits extracted on each shard.
    ``signed`` selects balanced digits (B = 2^(c-1) + 1). Returns the point
    as a replicated packed row (rowlen,)."""
    D = mesh.shape[axis]
    stages = D.bit_length() - 1
    if 1 << stages != D:
        raise ValueError(f"the {axis!r} axis must have a power-of-two size, not {D}")

    def local(p, pk, dg):
        if from_limbs:
            dg = MS.windows_from_limbs(dg, c, signed)
        return MS.window_buckets(fops, pk, dg, c, signed=signed)

    buckets = smap(local, as_sharded(mesh, points_packed, axis), as_sharded(mesh, digits, axis), axis=axis)
    for s in range(stages):
        other = ppermute(buckets, axis, [(i, i ^ (1 << s)) for i in range(D)])
        buckets = smap(lambda p, a, b: MS._add(fops, a, b), buckets, other, axis=axis)
    return smap(lambda p, b: MS.bucket_reduce_horner(fops, b[None], c)[0], buckets, axis=None)


def sharded_h_pipeline(mesh: Mesh, dom: Domain, az, bz, cz, axis: str = "ntt") -> Sharded:
    """The Groth16 h(x) quotient with every NTT element-sharded over
    ``axis``: iNTT, coset scale and NTT of each input, a b - c, divide by Z,
    inverse coset transform. The element-wise steps run on each position's
    chunk; the only exchanges are the bit-reversal gathers and the
    butterflies' chunk swaps inside each ``sharded_ntt``.

    az / bz / cz: (m, 16) canonical limbs, whole or Sharded. Returns the
    (m, 16) Montgomery h coefficients (the h pipeline's contract), Sharded
    along ``axis``."""
    C = dom.m // mesh.shape[axis]

    def chunk(p, table):
        d = mesh.axis_index(p, axis)
        return table[d * C : (d + 1) * C]

    def coset_eval(x):
        x = smap(lambda p, v: F.to_mont(FR, v.to(torch.int32)), as_sharded(mesh, x, axis), axis=axis)
        x = sharded_ntt(mesh, dom, x, axis=axis, inverse=True)  # == ifft
        x = smap(lambda p, v: F.mont_mul(FR, v, chunk(p, _domain_on(dom, v.device)._powers(dom.g))), x, axis=axis)
        return sharded_ntt(mesh, dom, x, axis=axis, inverse=False)

    a, b, c = (coset_eval(v) for v in (az, bz, cz))

    def quotient(p, a, b, c):
        t = F.sub(FR, F.mont_mul(FR, a, b), c)
        return F.mont_mul(FR, t, _domain_on(dom, a.device)._scalar(dom.z_on_coset_inv)[None, :])

    h = sharded_ntt(mesh, dom, smap(quotient, a, b, c, axis=axis), axis=axis, inverse=True)
    return smap(lambda p, v: F.mont_mul(FR, v, chunk(p, _domain_on(dom, v.device)._powers(dom.g_inv))), h,
                axis=axis)


def dp_sharding(mesh: Mesh, axis: str = "dp") -> Placement:
    """The placement of a batch-of-proofs axis (no exchange between its
    positions)."""
    return Placement(mesh, axis)


def dp_batch_ntt(mesh: Mesh, dom: Domain, values, axis: str = "dp") -> Sharded:
    """Batched NTT over a proof axis sharded across the mesh: values
    (B, m, 16), B split over ``axis``; each position transforms its proofs."""
    return smap(lambda p, v: _domain_on(dom, v.device).fft(v), as_sharded(mesh, values, axis), axis=axis)


__all__ = [
    "Mesh", "make_mesh", "Sharded", "Placement", "shard", "gather", "smap", "ppermute", "all_gather",
    "as_sharded", "sharded_pippenger", "sharded_sorted_msm", "sharded_ntt", "sharded_h_pipeline",
    "dp_sharding", "dp_batch_ntt",
]
