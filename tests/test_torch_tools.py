"""The port's measurement tools and their kernels' plain versions
(masp_tpu_torch/kernels/int8_dot.py, kernels/mont_mul_mxu.py,
masp_tpu_torch/tools/) against the JAX tools' own functions
(tools/bench_kernel_micro.py, tools/exp_mxu_mont.py, loaded by path and not
edited), numpy and host ints. Integer arithmetic: the tolerance is exact
equality throughout.

The tools' ``main`` runs here on the CPU at small sizes, where every kernel
wrapper runs its plain version. The MSM sweep uses c = 4 (the batch-affine
ladder) and c = 6 (43 windows, which the affine ladder rejects, so the tool
runs the scan ladder); c = 8 is left to the card, its plain CPU MSM alone
costs ~30 s of plain point adds."""

import importlib.util
import os
import random
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masp_tpu.kernels import field_kernels as KJ
from masp_tpu.ops import field_jax as FJ
from masp_tpu_torch.host.bls12_381 import G1, R
from masp_tpu_torch.kernels import LAUNCHES
from masp_tpu_torch.kernels import int8_dot as I8
from masp_tpu_torch.kernels import mont_mul as MK
from masp_tpu_torch.kernels import mont_mul_mxu as MX
from masp_tpu_torch.ops import msm_sorted as MS
from masp_tpu_torch.ops.field import FQ
from masp_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints
from masp_tpu_torch.tools import bench_kernel_micro as BT
from masp_tpu_torch.tools import exp_mxu_mont as ET

TOOLS = Path(__file__).resolve().parent.parent / "tools"
POINTS = 1 << 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under pytest-xdist, workers share the CPU: one intra-op thread each
    keeps torch's thread pools from oversubscribing it."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_exp():
    """tools/exp_mxu_mont.py as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location("_jax_exp_mxu_mont", TOOLS / "exp_mxu_mont.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jax_dot(x, w):
    """The body of the JAX tool's dot_kernel."""
    return jax.lax.dot_general(jnp.asarray(x), jnp.asarray(w), (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)


def _int8(rng, lo, hi, shape):
    return rng.integers(lo, hi, shape, dtype=np.int8)


@pytest.mark.parametrize("lo,hi", [(0, 127), (-128, 128)], ids=["tool-range", "signed-range"])
def test_int8_dot_plain_matches_jax_and_numpy(lo, hi):
    rng = np.random.default_rng(3)
    x, w = _int8(rng, lo, hi, (1024, 48)), _int8(rng, lo, hi, (48, 96))
    if lo < 0:  # the range's ends meet in the first rows and columns
        x[0], w[:, 0], x[1], w[:, 1] = -128, -128, 127, 127
    got = I8.int8_dot(torch.as_tensor(x), torch.as_tensor(w))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(_jax_dot(x, w)))
    assert np.array_equal(got.numpy(), x.astype(np.int32) @ w.astype(np.int32))


def _pallas_dot(x, w):
    """The JAX tool's dot_kernel, as it runs off the TPU: its body in
    pl.pallas_call, interpreted."""
    from jax.experimental import pallas as pl

    def dot_kernel(x_ref, w_ref, o_ref):
        o_ref[:] = jax.lax.dot_general(x_ref[:], w_ref[:], (((1,), (0,)), ((), ())),
                                       preferred_element_type=jnp.int32)

    out = jax.ShapeDtypeStruct((x.shape[0], w.shape[1]), jnp.int32)
    return np.asarray(pl.pallas_call(dot_kernel, out_shape=out, interpret=True)(jnp.asarray(x), jnp.asarray(w)))


# the kernel's ragged depths: not a multiple of 4 (x's byte path), the least, the greatest
@pytest.mark.parametrize("M,K,N", [(1003, 37, 90), (1024, 1, 96), (1024, 64, 96)])
def test_int8_dot_plain_matches_jax_dot_kernel_at_ragged_depths(M, K, N):
    """The plain version (which a CPU tensor runs, counting no launch)
    equals the JAX tool's dot_kernel and numpy on the signed range."""
    rng = np.random.default_rng(7)
    x, w = _int8(rng, -128, 128, (M, K)), _int8(rng, -128, 128, (K, N))
    x[0], w[:, 0] = -128, -128
    before = dict(LAUNCHES)
    got = I8.int8_dot(torch.as_tensor(x), torch.as_tensor(w))
    assert LAUNCHES == before
    assert got.dtype == torch.int32 and tuple(got.shape) == (M, N)
    assert np.array_equal(got.numpy(), _pallas_dot(x, w))
    assert np.array_equal(got.numpy(), x.astype(np.int32) @ w.astype(np.int32))


@pytest.mark.parametrize("k", [8, 64])
def test_int8_dot_loop_plain_matches_jax_fori_loop(k):
    """The JAX tool's mm_loop_kernel body: acc + dot, k times."""
    rng = np.random.default_rng(4)
    x, w = _int8(rng, 0, 127, (1024, 48)), _int8(rng, 0, 127, (48, 96))
    want = jax.lax.fori_loop(0, k, lambda i, acc: acc + _jax_dot(x, w), jnp.zeros((1024, 96), jnp.int32))
    got = I8.int8_dot_loop(torch.as_tensor(x), torch.as_tensor(w), k)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _canonical_block(smem, desc, rows):
    """A k32 block (rows x 32 bytes) as wgmma reads it through ``desc``,
    by the PTX ISA's canonical K-major layout without swizzle: start
    address, leading byte offset (the next core matrix along K) and stride
    byte offset (the next 8 rows), each stored >> 4; core matrices of 8
    rows x 16 bytes, 128 contiguous bytes each."""
    start, lbo, sbo = ((desc >> s & 0x3FFF) << 4 for s in (0, 16, 32))
    assert desc >> 62 == 0  # layout type: no swizzle
    r, k = np.meshgrid(np.arange(rows), np.arange(I8.K_STEP), indexing="ij")
    return smem[start + (r // 8) * sbo + (k // 16) * lbo + (r % 8) * 16 + k % 16]


def test_int8_dot_loop_layout_models():
    """int8_dot_loop_kernel's layout on the host: the staged x tile and w^T
    columns, read back through the descriptors by the PTX ISA's addressing,
    give the operands' k32 blocks (zero past M, K and N), and A's register
    fragment gives x's; numpy's tile product scattered into the s32
    accumulator fragment, stored through the epilogue's map, summed over
    the rep slices and read by each rank's band equals reps x the product
    modulo 2^32; rep_slices splits reps into slices that differ by at most
    one."""
    S = I8.CLUSTER
    for reps in (0, 1, S - 1, S, S + 1, 64, 32768):
        got = I8.rep_slices(reps)
        assert len(got) == S and sum(got) == reps and max(got) - min(got) <= 1
    for M, K, N in ((1024, 48, 96), (1003, 37, 90), (1024, 1, 96), (1024, 64, 96)):
        rng = np.random.default_rng(M + K + N)
        x, w = _int8(rng, -128, 128, (M, K)), _int8(rng, -128, 128, (K, N))
        xp = np.zeros((-(-M // 64) * 64, I8.K_PAD), np.int8)
        wp = np.zeros((I8.K_PAD, -(-N // I8.LOOP_TILE_N) * I8.LOOP_TILE_N), np.int8)
        xp[:M, :K], wp[:K, :N] = x, w
        base = 0x400  # shared memory: x's tile, then w's columns (the kernel's order)
        xs_bytes = I8.LOOP_TILE_M * I8.K_PAD
        for row0 in (0, (M - 1) // 64 * 64):
            for col0 in range(0, N, I8.LOOP_TILE_N):
                smem = np.zeros(base + xs_bytes + I8.LOOP_TILE_N * I8.K_PAD, np.int8)
                smem[base : base + xs_bytes] = I8.stage_x(x, row0)
                smem[base + xs_bytes :] = I8.stage_wt(w, col0)
                xt, wt = xp[row0 : row0 + 64], wp[:, col0 : col0 + I8.LOOP_TILE_N].T
                for s in range(I8.K_PAD // I8.K_STEP):
                    da = I8.smem_desc(base) + s * I8.DESC_K_STEP
                    db = I8.smem_desc(base + xs_bytes) + s * I8.DESC_K_STEP
                    ks = slice(I8.K_STEP * s, I8.K_STEP * (s + 1))
                    assert np.array_equal(_canonical_block(smem, da, 64), xt[:, ks])
                    assert np.array_equal(_canonical_block(smem, db, I8.LOOP_TILE_N), wt[:, ks])
                    for warp in range(4 if (row0, col0) == (0, 0) else 0):
                        for lane in range(32):
                            for reg in range(4):
                                for b in range(4):
                                    r, k = I8.a_position(warp, lane, reg, b)
                                    assert smem[base + I8.staged_offset(r, I8.K_STEP * s + k)] == xt[r, ks][k]
                if (row0, col0) != (0, 0):
                    continue
                prod = xt.astype(np.int64) @ wt.T.astype(np.int64)
                regs = np.zeros((4, 32, I8.LOOP_TILE_N // 2), np.int64)
                for warp in range(4):
                    for lane in range(32):
                        for i in range(I8.LOOP_TILE_N // 2):
                            regs[warp, lane, i] = prod[I8.acc_position(warp, lane, i)]
                reps = 32768 + 3
                parts = np.zeros((I8.CLUSTER, 64, I8.PART_STRIDE), np.int64)
                for slice_, n in enumerate(I8.rep_slices(reps)):
                    for warp in range(4):
                        for lane in range(32):
                            for r, c, i in I8.epilogue_pairs(warp, lane):
                                parts[slice_, r, c : c + 2] += n * regs[warp, lane, i : i + 2]
                out = np.zeros((64, I8.LOOP_TILE_N), np.int64)
                seen = np.zeros(out.shape, bool)  # each element written by one rank, once
                for rank in range(I8.CLUSTER):
                    for r, c in I8.band_chunks(rank):
                        assert not seen[r, c : c + 4].any()
                        seen[r, c : c + 4] = True
                        out[r, c : c + 4] = parts[:, r, c : c + 4].sum(axis=0) % (1 << 32)
                assert seen.all()
                want = (reps * prod) % (1 << 32)
                assert np.array_equal(out, want)
                assert np.array_equal(out.astype(np.uint32).view(np.int32)[: min(M, 64), :N],
                                      I8.int8_dot_loop_plain(torch.as_tensor(x[:64]), torch.as_tensor(w[:, : I8.LOOP_TILE_N]),
                                                             reps).numpy()[:, :N])


def test_int8_dot_loop_constants_match_cuda_source():
    """csrc/int8_dot.cu's tile, layout and cluster constants equal the
    Python model's."""
    import re

    src = (Path(I8.__file__).resolve().parent.parent / "csrc" / "int8_dot.cu").read_text()
    consts = {m.group(1): m.group(2) for m in re.finditer(r"constexpr int (\w+) = ([^;]+);", src)}
    for name in ("LOOP_TILE_M", "LOOP_TILE_N", "K_PAD", "K_STEP", "CLUSTER", "LBO", "SBO", "SWIZZLE",
                 "PART_STRIDE"):
        assert int(consts[name]) == getattr(I8, name), name
    instr = re.findall(r'"(wgmma\.mma_async[^ "]*)', src)  # the product: wraps, no .satfinite
    assert instr == [f"wgmma.mma_async.sync.aligned.m64n{I8.LOOP_TILE_N}k{I8.K_STEP}.s32.s8.s8"]
    assert "mma.sync" in src.split("int8_dot_loop: reps products")[0]
    assert "mma.sync" not in src.split("int8_dot_loop: reps products")[1]


def test_mxu_consts_match_the_tool(jax_exp):
    want = jax_exp._mxu_consts(FJ.FQ)
    got = MX.mxu_consts(FQ)
    assert tuple(want) == MX.CONST_KEYS == tuple(got)
    for key in MX.CONST_KEYS:
        w = np.asarray(want[key])
        assert got[key].dtype == w.dtype and np.array_equal(got[key], w), key


def test_kernel_fragments_hold_the_unsigned_toeplitz_bytes():
    """The kernel's u8 matrices give the reference's lazy columns, and its
    mma.sync m16n8k32 A fragments (block (mt, ks) of band_blocks, lane 4g +
    t: bytes 32ks + 4t.. of rows 16mt + g and 16mt + g + 8, then bytes
    32ks + 16 + 4t.. of the same rows) unpack to them, the depth padded
    with zeros to 64; the blocks left out are zero."""
    consts = MX.mxu_consts(FQ)
    chunks = np.random.default_rng(5).integers(0, 256, (48, 40))
    for A, (m, b, c) in zip(MX.unsigned_toeplitz(consts), (("M1t", "B1", "C1"), ("M2t", "B2", "C2"))):
        M, B = consts[m].astype(np.int64), consts[b].astype(np.int64)
        recentred = M @ (chunks - 128) + 128 * (B @ (chunks - 128)) + consts[c]
        assert np.array_equal(A.astype(np.int64) @ chunks, recentred)
        frag = MX.fragments(A)
        blocks = MX.band_blocks(A.shape[0])
        assert frag.shape == (len(blocks), 32, 4) and len(blocks) == {48: 4, 96: 9}[A.shape[0]]
        fbytes = np.ascontiguousarray(frag.astype("<u4")).view(np.uint8).reshape(frag.shape + (4,))
        got = np.zeros((A.shape[0], 64), dtype=A.dtype)
        for (mt, ks), fb in zip(blocks, fbytes):
            for lane in range(32):
                g, t = divmod(lane, 4)
                for reg in range(4):
                    col = 32 * ks + 16 * (reg // 2) + 4 * t
                    got[16 * mt + g + 8 * (reg % 2), col : col + 4] = fb[lane, reg]
        assert np.array_equal(got[:, :48], A) and not got[:, 48:].any()


def test_mont_mul_mxu_plain_matches_reference_row_function(jax_exp):
    """One (8, 128) tile of reduced Fq elements, 0, 1, N-1 and mont-1 among
    them: the plain version against rows_mont_mul_mxu run eagerly, the JAX
    package's mont_mul (compact), the port's mont_mul_plain and host ints."""
    N = FQ.modulus
    rng = random.Random(6)
    edge = [0, 1, N - 1, FQ.R_mod]
    xs = edge + [rng.randrange(N) for _ in range(1024 - 4)]
    ys = edge[::-1] + [N - 1, FQ.R_mod] + [rng.randrange(N) for _ in range(1024 - 6)]
    xa, ya = ints_to_limbs(xs, FQ.L), ints_to_limbs(ys, FQ.L)
    a, b = torch.as_tensor(xa.astype(np.int32)), torch.as_tensor(ya.astype(np.int32))
    got = MX.mont_mul_mxu(FQ, a, b)

    def tile(arr):  # (1024, 24) -> 24 rows of (8, 128), the kernel's layout
        return [jnp.asarray(arr[:, i].reshape(KJ.TB, KJ.LANE)) for i in range(FQ.L)]

    rows = jax_exp.rows_mont_mul_mxu(FJ.FQ, jax_exp._mxu_consts(FJ.FQ), tile(xa), tile(ya))
    ref = np.stack([np.asarray(r).reshape(-1) for r in rows], axis=1)
    assert np.array_equal(got.numpy(), ref.astype(np.int32))
    assert np.array_equal(got.numpy(), np.asarray(FJ.mont_mul(FJ.FQ, jnp.asarray(xa), jnp.asarray(ya))).astype(np.int32))
    assert torch.equal(got, MK.mont_mul_plain(FQ, a, b))
    rinv = pow(FQ.R, -1, N)
    assert limbs_to_ints(got.numpy()) == [x * y * rinv % N for x, y in zip(xs, ys)]


def test_wrappers_check_inputs_and_count_no_cpu_launch():
    x = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(TypeError):
        I8.int8_dot(x.to(torch.int32), x.T)
    with pytest.raises(ValueError):
        I8.int8_dot(x, x)
    with pytest.raises(ValueError):
        I8.int8_dot_loop(x, x.T.contiguous(), -1)
    a = torch.zeros(4, FQ.L, dtype=torch.int32)
    with pytest.raises(TypeError):
        MX.mont_mul_mxu(FQ, a.to(torch.int64), a)
    with pytest.raises(ValueError):
        MX.mont_mul_mxu(FQ, a, a[:3])
    before = dict(LAUNCHES)
    I8.int8_dot(x, x.T.contiguous())
    I8.int8_dot_loop(x, x.T.contiguous(), 3)
    MX.mont_mul_mxu(FQ, a, a)
    assert LAUNCHES == before


def test_bench_kernel_micro_on_cpu(monkeypatch):
    """The microbenchmark's sections at small sizes: its MSM results equal
    the host MSM of its points and scalars, and the c the affine ladder
    rejects runs, and is named, the scan ladder. One affine level, as in
    tests/test_torch_msm.py: each level pays a plain Fermat chain here."""
    monkeypatch.setattr(MS, "AFFINE_LEVELS", 1)
    lines = []
    report = BT.main(device="cpu", rows=256, points=POINTS, cs=(4, 6), iters=1, msm_iters=1, log=lines.append)
    assert set(report) == {"g1_add", "mont_mul_fq", "int8_dot_loop", "msm"}
    assert {c: r["ladder"] for c, r in report["msm"].items()} == {4: "affine", 6: "scan"}
    assert any("c=6 (43 windows, scan ladder)" in s for s in lines)
    assert any("OK (exact against numpy)" in s for s in lines)
    # the tool's data, drawn again: 64 copies of one point, seeded scalars
    rng = np.random.default_rng(BT.SEED)
    for shape in ((256, FQ.L), (256, FQ.L)):
        rng.integers(0, 1 << 16, shape)
    rng.integers(0, 127, (1024, 48), dtype=np.int8)
    rng.integers(0, 127, (48, 96), dtype=np.int8)
    scal = rng.integers(0, 1 << 16, (POINTS, 16), dtype=np.uint16)
    want = G1.generator() * (987654321 * sum(limbs_to_ints(scal)) % R)
    for c, r in report["msm"].items():
        assert BT._g1_point(torch.as_tensor(r["row"])) == want, c


def test_exp_mxu_mont_on_cpu():
    lines = []
    report = ET.main(device="cpu", rows=256, iters=1, log=lines.append)
    assert report["exact"] is True
    assert set(report) == {"exact", "production", "mxu"}
    assert any("exact vs production and host ints" in s and s.endswith("True") for s in lines)


def test_tools_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        BT.main()
    with pytest.raises(RuntimeError):
        ET.main()


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(1003, 37, 90), (1024, 1, 96), (1024, 64, 96), (1024, 48, 96)])
def test_int8_dot_kernel_matches_plain(cuda_device, M, K, N):
    """The single-product kernel at ragged and edge depths and at the tools'
    shape, on the signed range: one launch each."""
    rng = np.random.default_rng(10)
    x = torch.as_tensor(_int8(rng, -128, 128, (M, K)), device=cuda_device)
    w = torch.as_tensor(_int8(rng, -128, 128, (K, N)), device=cuda_device)
    before = LAUNCHES["int8_dot"]
    assert torch.equal(I8.int8_dot(x, w), I8.int8_dot_plain(x, w))
    assert LAUNCHES["int8_dot"] == before + 1


@pytest.mark.cuda
def test_tool_kernels_match_plain(cuda_device):
    rng = np.random.default_rng(8)
    x = torch.as_tensor(_int8(rng, -128, 128, (1003, 40)), device=cuda_device)
    w = torch.as_tensor(_int8(rng, -128, 128, (40, 90)), device=cuda_device)
    assert torch.equal(I8.int8_dot(x, w), I8.int8_dot_plain(x, w))
    assert torch.equal(I8.int8_dot_loop(x, w, 8), I8.int8_dot_loop_plain(x, w, 8))
    vals = [random.Random(9).randrange(FQ.modulus) for _ in range(1003)]
    a = torch.as_tensor(ints_to_limbs(vals, FQ.L).astype(np.int32), device=cuda_device)
    b = a.flip(0).contiguous()
    got = MX.mont_mul_mxu(FQ, a, b)
    assert torch.equal(got, MX.mont_mul_mxu_plain(FQ, a, b))
    assert torch.equal(got, MK.mont_mul(FQ, a, b))
