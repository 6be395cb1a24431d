"""Parity of the port's limb field arithmetic (masp_tpu_torch.ops.field and
the Montgomery kernel's plain version) with the JAX package and host ints.
Integer arithmetic: every comparison is exact equality."""

import os
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masp_tpu.ops import field_jax as FJ
from masp_tpu.ops import limbs as LJ
from masp_tpu_torch import resolve_device
from masp_tpu_torch.kernels import LAUNCHES
from masp_tpu_torch.kernels import mont_mul as MK
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops import limbs as LT


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under pytest-xdist, workers share the CPU: one intra-op thread each
    keeps torch's thread pools from oversubscribing it."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SPECS = {"Fr": (F.FR, FJ.FR), "Fq": (F.FQ, FJ.FQ)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ints(modulus: int, n: int, seed: int) -> list[int]:
    """0, 1, N-1, 2, N-2 and random values below the modulus."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 63, size=(n, 7), dtype=np.int64)
    rand = [int("".join(f"{int(w):016x}" for w in row), 16) % modulus for row in words]
    return [0, 1, modulus - 1, 2, modulus - 2] + rand


def _t(arr) -> torch.Tensor:
    return torch.as_tensor(np.asarray(arr).astype(np.int32))


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_field_ops_match_jax_and_host(name):
    spec, jspec = SPECS[name]
    xs = _ints(spec.modulus, 59, 1)
    ys = list(reversed(_ints(spec.modulus, 59, 2)))
    ys[0] = spec.modulus - 1  # 0 * (N-1), 1 * (N-1) ... among the lanes
    xa, ya = F.encode(spec, xs), F.encode(spec, ys)
    # the Montgomery 1 is the encoding of 1: lane 1 of xa
    assert np.array_equal(xa[1], spec.ONE_MONT)
    a, b = _t(xa), _t(ya)
    ja, jb = jnp.asarray(xa), jnp.asarray(ya)
    N = spec.modulus
    cases = [
        (F.mont_mul, FJ.mont_mul, lambda x, y: x * y % N),
        (F.add, FJ.add, lambda x, y: (x + y) % N),
        (F.sub, FJ.sub, lambda x, y: (x - y) % N),
    ]
    for port_fn, jax_fn, host in cases:
        got = port_fn(spec, a, b)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(jax_fn(jspec, ja, jb)).astype(np.int32))
        assert F.decode(spec, got) == [host(x, y) for x, y in zip(xs, ys)]
    assert np.array_equal(F.neg(spec, a).numpy(), np.asarray(FJ.neg(jspec, ja)).astype(np.int32))
    raw = _t(F.encode(spec, xs, mont=False))
    assert np.array_equal(F.to_mont(spec, raw).numpy(), xa.astype(np.int32))
    assert np.array_equal(F.from_mont(spec, a).numpy(), np.asarray(FJ.from_mont(jspec, ja)).astype(np.int32))
    assert F.decode(spec, F.from_mont(spec, a), mont=False) == xs


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_mont_mul_broadcasts_symmetrically(name):
    spec, _ = SPECS[name]
    xs = _ints(spec.modulus, 11, 3)
    a = _t(F.encode(spec, xs))
    c = _t(F.encode(spec, [12345]))[0]
    want = [x * 12345 % spec.modulus for x in xs]
    assert F.decode(spec, F.mont_mul(spec, a, c)) == want
    assert F.decode(spec, F.mont_mul(spec, c, a)) == want


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_mont_mul_reads_views_through_row_maps(name, monkeypatch):
    """The operand forms of the main path at m = 64 rows a transform: an NTT
    stage's odd half with its twiddles broadcast (h = 1, 4, m / 2), powers
    broadcast over three transforms, a scalar in either order, contiguous
    rows and a product-tree step's halves. The row map's rows equal the
    materialised view's; F.mont_mul on the view equals the JAX package's
    mont_mul on the same numpy rows and host ints; and F.mont_mul hands the
    kernel's wrapper the stage's odd half and twiddles as views."""
    spec, jspec = SPECS[name]
    L, m = spec.L, 64
    x = _t(F.encode(spec, _ints(spec.modulus, 3 * m - 5, 11))).reshape(3, m, L)
    y = _t(F.encode(spec, _ints(spec.modulus, m - 5, 12)))
    forms = {}
    for h in (1, 4, m // 2):
        forms[f"stage h={h}"] = (x.reshape(3, m // (2 * h), 2, h, L)[..., 1, :, :], y[:h][None])
    forms.update({"powers": (x, y), "scalar": (x, y[7]), "scalar first": (y[7], x),
                  "contiguous": (x[0], x[1]), "tree step": (y[: m // 2], y[m // 2 :])})
    # the row maps of the stage forms, as the kernel is given them
    odd, tw = forms["stage h=4"][0], forms["stage h=4"][1].expand(3, m // 8, 4, L)
    assert MK.row_map(odd) == (4, 8 * L, L) and MK.row_map(tw) == (4, 0, L)
    assert MK.row_map(forms["stage h=1"][0]) == (3 * m // 2, 0, 2 * L)
    assert MK.row_map(odd.expand(2, *odd.shape)) is None  # three levels: copied
    rows_a, rows_b, got = [], [], []
    for a, b in forms.values():
        shape = torch.broadcast_shapes(a.shape, b.shape)
        for t, rows in ((a.expand(shape), rows_a), (b.expand(shape), rows_b)):
            rows.append(t.reshape(-1, L))
            assert torch.equal(MK.mapped_rows(t, MK.row_map(t)), rows[-1])
        out = F.mont_mul(spec, a, b)
        assert out.shape == shape and out.is_contiguous()
        got.append(out.reshape(-1, L))
    ra, rb, got = torch.cat(rows_a), torch.cat(rows_b), torch.cat(got)
    want = FJ.mont_mul(jspec, jnp.asarray(ra.numpy().astype(np.uint32)), jnp.asarray(rb.numpy().astype(np.uint32)))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    assert F.decode(spec, got) == [u * v % spec.modulus for u, v in zip(F.decode(spec, ra), F.decode(spec, rb))]

    seen = []
    real = MK.mont_mul

    def record(spec_, a, b):
        seen.append((a.is_contiguous(), a.stride(), b.is_contiguous(), b.stride()))
        seen.append((MK.row_map(a), MK.row_map(b)))
        return real(spec_, a, b)

    monkeypatch.setattr(MK, "mont_mul", record)
    F.mont_mul(spec, *forms["stage h=4"])
    assert seen[:2] == [(False, (m * L, 8 * L, L, 1), False, (0, 0, L, 1)), ((4, 8 * L, L), (4, 0, L))]
    F.mont_mul(spec, *forms[f"stage h={m // 2}"])  # one butterfly group a transform
    assert seen[2][::2] == (False, False) and seen[3] == ((m // 2, m * L, L), (m // 2, 0, L))
    seen.clear()
    F.mont_mul(spec, *forms["powers"])
    assert seen[0] == (True, (m * L, L, 1), False, (0, L, 1))
    F.mont_mul(spec, *forms["scalar first"])
    assert seen[2] == (False, (0, 0, 1), True, (m * L, L, 1)) and seen[3] == ((3 * m, 0, 0), (3 * m, 0, L))


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_plain_mont_mul_small_batches_match_limb_path(name):
    """Up to MK.INT_ROWS rows the plain product runs on Python ints: the
    same limbs as the limb path, inputs at or above the modulus (below R)
    included."""
    spec, _ = SPECS[name]
    rng = np.random.default_rng(7)
    k = MK.INT_ROWS
    edge = [0, 1, spec.modulus - 1, spec.modulus, spec.modulus + 1, spec.R - 1]
    vals = edge + [int(rng.integers(0, 1 << 62)) * spec.R // (1 << 62) for _ in range(3 * k - len(edge))]
    a = _t(LT.ints_to_limbs(vals, spec.L))
    b = _t(LT.ints_to_limbs(vals[::-1], spec.L))
    want = MK.mont_mul_plain(spec, a, b)  # 3 INT_ROWS rows: the limb path
    got = torch.cat([MK.mont_mul_plain(spec, a[i : i + k], b[i : i + k]) for i in range(0, 3 * k, k)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_inversions_match_jax_and_host(name):
    spec, jspec = SPECS[name]
    xs = _ints(spec.modulus, 13, 4)
    a = _t(F.encode(spec, xs))
    got = F.batch_mont_inv(spec, a)
    assert F.decode(spec, got) == [pow(x, -1, spec.modulus) if x else 0 for x in xs]
    want = FJ.batch_mont_inv(jspec, jnp.asarray(F.encode(spec, xs)))
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int32))
    if name == "Fq":  # the plain Fermat chain once: ~760 dependent products
        two = a[3:4]
        assert torch.equal(F.mont_inv(spec, two), F.mont_inv_small(spec, two))


def test_mont_mul_matches_pallas_interpret():
    """The plain version against the Pallas kernel itself (interpret mode)
    at 1024 lanes."""
    from masp_tpu.kernels.field_kernels import pallas_mont_mul

    xs = _ints(F.FR.modulus, 1019, 5)
    ys = _ints(F.FR.modulus, 1019, 6)[::-1]
    xa, ya = F.encode(F.FR, xs), F.encode(F.FR, ys)
    want = np.asarray(pallas_mont_mul(FJ.FR, jnp.asarray(xa), jnp.asarray(ya)))
    assert np.array_equal(F.mont_mul(F.FR, _t(xa), _t(ya)).numpy(), want.astype(np.int32))


def test_limb_codecs_match_jax():
    xs = _ints(F.FQ.modulus, 20, 7)
    assert np.array_equal(LT.ints_to_limbs(xs, 24), LJ.ints_to_limbs(xs, 24))
    arr = LJ.ints_to_limbs(xs, 24)
    assert LT.limbs_to_ints(arr) == LJ.limbs_to_ints(arr) == xs
    assert LT.limbs_to_int(arr[5]) == xs[5]
    assert np.array_equal(LT.int_to_limbs(xs[2], 24), LJ.int_to_limbs(xs[2], 24))
    with pytest.raises(ValueError):
        LT.int_to_limbs(1 << 384, 24)


def test_field_constants_match_cuda_source():
    """The moduli, -N^-1 mod 2^32 and Fq's Montgomery 1 written into the CUDA
    header as 32-bit words agree with the field specs."""
    src = (Path(__file__).resolve().parent.parent / "masp_tpu_torch/csrc/field.cuh").read_text()

    def words(name):
        body = re.search(name + r"\[\d+\] = \{([^}]*)\}", src).group(1)
        return sum(int(w.strip().rstrip("u"), 16) << (32 * i) for i, w in enumerate(body.split(",")))

    assert words("FR_N") == F.FR.modulus
    assert words("FQ_N") == F.FQ.modulus
    assert words("FQ_ONE") == F.FQ.R_mod
    assert words("FR_ONE") == F.FR.R_mod
    for struct, spec in (("Fr", F.FR), ("Fq", F.FQ)):
        ninv = re.search(r"struct " + struct + r" \{.*?NINV = (0x[0-9a-f]+)u", src, re.S).group(1)
        assert int(ninv, 16) == (-pow(spec.modulus, -1, 1 << 32)) % (1 << 32)


def test_mont_mul_wrapper_checks_inputs():
    a = torch.zeros(4, 16, dtype=torch.int32)
    with pytest.raises(TypeError):
        MK.mont_mul(F.FR, a.to(torch.int64), a)
    with pytest.raises(ValueError):
        MK.mont_mul(F.FR, a, torch.zeros(3, 16, dtype=torch.int32))
    with pytest.raises(ValueError):
        MK.mont_mul(F.FQ, a, a)
    before = dict(LAUNCHES)
    MK.mont_mul(F.FR, a, a)  # a CPU tensor runs the plain version, uncounted
    assert LAUNCHES == before


def test_cuda_entry_point_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Fr", "Fq"])
@pytest.mark.parametrize("width", [1, 3, 32, 1003, 3005])
def test_mont_mul_kernel_matches_plain(cuda_device, name, width):
    spec, _ = SPECS[name]
    xs = _ints(spec.modulus, 3000, 8)
    a = _t(F.encode(spec, xs)).to(cuda_device)[:width]
    b = a.flip(0).contiguous()
    before = LAUNCHES["mont_mul_" + name.lower()]
    got = MK.mont_mul(spec, a, b)
    assert LAUNCHES["mont_mul_" + name.lower()] == before + 1
    assert torch.equal(got, MK.mont_mul_plain(spec, a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 3, 32, 1003])
def test_mont_inv_kernel_matches_plain(cuda_device, width):
    """The inversion kernels of Fr and Fq on 0, 1, N - 1, 2, N - 2 and
    random rows, bit for bit against their plain chains and host ints."""
    for name, (spec, _) in SPECS.items():
        a = _t(F.encode(spec, _ints(spec.modulus, 1000, 9)[::-1][-width:])).to(cuda_device)
        counter = "mont_inv_" + name.lower()
        before = LAUNCHES[counter]
        got = MK.mont_inv(spec, a)
        assert LAUNCHES[counter] == before + 1
        assert torch.equal(got, MK.mont_inv_plain(spec, a))
        assert F.decode(spec, got) == [pow(x, spec.modulus - 2, spec.modulus) for x in F.decode(spec, a)]
