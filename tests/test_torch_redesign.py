"""The CPU side of the redesigned kernels: the inversion kernel's plain
version for Fq and Fr (the divstep GCD, against the JAX package's Fermat
chain, the port's chain over the plain product and host ints), its constants
in the CUDA source, and its routing (kernels/mont_mul.mont_inv: every
inversion of the proof path is one launch), the adds' thread schedule on G1 and
G2 (kernels/point_add.ADD_L1 ... ADD_OUT, and LEAF_LIN for the leaf form) on
host ints and in the CUDA source, and the Edwards add's and the Pedersen
fold's layers (kernels/jubjub.ADD_LAYERS, FOLD_LAYERS and fold_table) on
host ints, against the plain versions, the host curve and the CUDA source,
and the square root's window walk (kernels/jubjub.SQRT_DIGITS) on host
ints and in the CUDA source. Integer arithmetic: every comparison is
exact."""

import functools
import os
import random
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from masp_tpu.ops import field_jax as FJ
from masp_tpu_torch.host.bls12_381 import G1, G2, Fq2, R
from masp_tpu_torch.host.fields import JubjubFr
from masp_tpu_torch.host.jubjub import ExtendedPoint
from masp_tpu_torch.host.primitives.constants import spending_key_generator
from masp_tpu_torch.kernels import LAUNCHES
from masp_tpu_torch.kernels import affine as AK
from masp_tpu_torch.kernels import jubjub as KJ
from masp_tpu_torch.kernels import mont_mul as MK
from masp_tpu_torch.kernels import point_add as PA
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops import pedersen as PED
from masp_tpu_torch.ops import weierstrass as W
from masp_tpu_torch.ops.field import FQ, FR
from masp_tpu_torch.ops.projective import unpack_rows

CSRC = Path(__file__).resolve().parent.parent / "masp_tpu_torch" / "csrc"
Q = FQ.modulus


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Under pytest-xdist, workers share the CPU: one intra-op thread each
    keeps torch's thread pools from oversubscribing it."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inv_vals(n, rows=256):
    """0, 1 (mont-1 once encoded), n - 1, 2, n - 2, then seeded values below
    n: rows - 2 in all, room for the two raw rows of ``_inv_tensor``."""
    rng = np.random.default_rng(61 + n % 1000)
    words = rng.integers(0, 1 << 62, size=(rows - 7, 7), dtype=np.int64)
    return [0, 1, n - 1, 2, n - 2] + [int("".join(f"{int(w):016x}" for w in row), 16) % n for row in words]


def _inv_tensor(spec, vals):
    """The Montgomery rows of ``vals``, then the raw rows 1 and N - 1
    (Montgomery values R^-1 and (N - 1) R^-1), as int32."""
    mont = F.encode(spec, vals)
    raw = F.encode(spec, [1, spec.modulus - 1], mont=False)
    return torch.as_tensor(np.concatenate([mont, raw]).astype(np.int32))


def _inv_rows():
    return _inv_tensor(FQ, _inv_vals(Q))


@pytest.fixture(scope="module")
def jax_inverses():
    """field_jax.mont_inv_small (compact impl) on _inv_rows(), jitted (one
    compile of the scan instead of ~490 eager dispatches) with XLA's backend
    optimisation off: the same integer program, compiled in about half the
    time."""
    rows = jnp.asarray(_inv_rows().numpy().astype(np.uint32))
    lowered = jax.jit(lambda a: FJ.mont_inv_small(FJ.FQ, a)).lower(rows)
    out = lowered.compile(compiler_options={"xla_backend_optimization_level": 0})(rows)
    return np.asarray(out).astype(np.int32)


def _host_inverses(rows, spec=FQ):
    n = spec.modulus
    return F.encode(spec, [pow(x, n - 2, n) for x in F.decode(spec, rows)]).astype(np.int32)


def _check_plain_inverse(spec, a, jax_inv, monkeypatch):
    """mont_inv_plain (the divstep GCD) against field_jax.mont_inv_small,
    the Fermat chain over the plain product and host ints, exactly, on its
    Python-int route (up to MK.INT_ROWS rows) and its int64 tensor route;
    on either, its check that g = 0 and f = +-1 after the fixed count fires
    when the count is cut."""
    assert a.shape[0] <= MK.INT_ROWS
    got = MK.mont_inv_plain(spec, a)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), jax_inv)
    assert torch.equal(got, MK.fermat_chain(spec, a, lambda x, y: MK.mont_mul_plain(spec, x, y)))
    assert np.array_equal(got.numpy(), _host_inverses(a, spec))
    assert F.decode(spec, got[:1]) == [0]  # zero maps to zero
    int_rows = MK.INT_ROWS
    monkeypatch.setattr(MK, "INT_ROWS", 0)
    assert torch.equal(MK.mont_inv_plain(spec, a), got)
    monkeypatch.setattr(MK.divstep_constants(spec), "batches", MK.divstep_constants(spec).batches // 2)
    for rows in (0, int_rows):
        monkeypatch.setattr(MK, "INT_ROWS", rows)
        with pytest.raises(AssertionError, match="fixed divstep count"):
            MK.mont_inv_plain(spec, a)
    return got


def _divsteps_by_definition(delta, f, g, steps=MK.DIVSTEPS):
    """Bernstein and Yang's divstep on whole ints: where delta > 0 and g is
    odd, (delta, f, g) <- (1 - delta, g, (g - f) / 2), else (1 + delta, f,
    (g + (g mod 2) f) / 2)."""
    for _ in range(steps):
        if delta > 0 and g & 1:
            delta, f, g = 1 - delta, g, (g - f) // 2
        else:
            delta, f, g = 1 + delta, f, (g + (g & 1) * f) // 2
    return delta, f, g


def test_mont_inv_plain_matches_jax_and_host(jax_inverses, monkeypatch):
    """The Fq inversion, and the plain version's batch of divsteps (int64
    tensors and Python ints) against the paper's definition: from the low
    30 bits of f and g alone, eta = -delta after 30 steps and the matrix
    that maps the whole (f, g) to 2^30 times the whole result (the step
    whose count the bound is proved for)."""
    _check_plain_inverse(FQ, _inv_rows(), jax_inverses, monkeypatch)
    rng = random.Random(30)
    cases = [(rng.randrange(-60, 61), rng.randrange(Q) | 1, rng.randrange(-Q, Q)) for _ in range(64)]
    cases += [(1, Q, 0), (1, Q, 1), (1, 1, Q - 1)]
    low = [[f % (1 << 30) for _, f, _ in cases], [g % (1 << 30) for _, _, g in cases]]
    eta, t = MK._divsteps(torch.tensor([-d for d, _, _ in cases]), *(torch.tensor(x) for x in low))
    for (d, f, g), e, ((u, v), (q, r)), f0, g0 in zip(cases, eta.tolist(), t.tolist(), *low):
        d30, f30, g30 = _divsteps_by_definition(d, f, g)
        assert (e, u * f + v * g, q * f + r * g) == (-d30, f30 << 30, g30 << 30)
        assert MK._divsteps_int(-d, f0, g0) == (e, (u, v, q, r))


def test_routed_inversions_match_jax_and_host(jax_inverses):
    """F.mont_inv_small runs the inversion kernel's wrapper (the plain version
    on a CPU tensor, uncounted); the product tree's default root goes the
    same way."""
    a = _inv_rows()
    before = dict(LAUNCHES)
    assert np.array_equal(F.mont_inv_small(FQ, a).numpy(), jax_inverses)
    assert np.array_equal(F.mont_inv_small(FQ, a.reshape(2, -1, FQ.L)).reshape(-1, FQ.L).numpy(), jax_inverses)
    d = a[1:9]  # eight non-zero rows
    assert np.array_equal(F.tree_batch_inv(FQ, d).numpy(), _host_inverses(d))
    assert np.array_equal(F.batch_mont_inv(FQ, a).numpy(), jax_inverses)
    assert LAUNCHES == before


def test_fr_inversion_plain_matches_jax_and_host(monkeypatch):
    """The Fr instance of the inversion (25 batches of divsteps): the plain
    version against field_jax.mont_inv_small over Fr (329 products), the
    plain Fermat chain and host ints, and the routed F.mont_inv_small, 0 ->
    0 included."""
    a = _inv_tensor(FR, _inv_vals(FR.modulus))
    rows = jnp.asarray(a.numpy().astype(np.uint32))
    lowered = jax.jit(lambda x: FJ.mont_inv_small(FJ.FR, x)).lower(rows)
    jax_inv = np.asarray(lowered.compile(compiler_options={"xla_backend_optimization_level": 0})(rows))
    got = _check_plain_inverse(FR, a, jax_inv.astype(np.int32), monkeypatch)
    monkeypatch.undo()
    before = dict(LAUNCHES)
    assert torch.equal(F.mont_inv_small(FR, a), got)
    assert LAUNCHES == before


def _counting_mont_inv(monkeypatch):
    calls = []
    real = MK.mont_inv

    def counted(spec, a):
        calls.append(tuple(a.shape))
        return real(spec, a)

    monkeypatch.setattr(MK, "mont_inv", counted)
    return calls


def _affine_rows(points):
    x, y, _ = W.encode_g1_points(points)
    f = np.zeros((len(points), 1), dtype=np.uint32)
    return torch.as_tensor(np.concatenate([x, y, f], axis=1).astype(np.int32))


def _affine_rows2(points):
    x, y, _ = W.encode_g2_points(points)
    f = np.zeros((len(points), 1), dtype=np.uint32)
    return torch.as_tensor(np.concatenate([x.reshape(len(points), -1), y.reshape(len(points), -1), f],
                                          axis=1).astype(np.int32))


def test_every_fermat_chain_is_one_inversion_call(monkeypatch):
    """The G1 affine level (which passes the field's own product to the
    tree), the G2 level through its denominators' norms, and the fetch's batched inversions
    on both groups each invert through one mont_inv call on one row, and so
    does the product tree's default root under a caller's own product."""
    calls = _counting_mont_inv(monkeypatch)
    rng = random.Random(62)
    g1 = G1.generator()
    p1 = [g1 * rng.randrange(1, R) for _ in range(4)]
    p2 = [g1 * rng.randrange(1, R) for _ in range(4)]
    got = AK.affine_level(_affine_rows(p1), _affine_rows(p2))
    assert torch.equal(got, _affine_rows([a + b for a, b in zip(p1, p2)]))
    assert torch.equal(got, AK.affine_level_plain(_affine_rows(p1), _affine_rows(p2)))
    assert calls == [(1, FQ.L)]  # the plain level runs its own chain
    q1 = [G2.generator() * rng.randrange(1, R) for _ in range(2)]
    q2 = [G2.generator() * rng.randrange(1, R) for _ in range(2)]
    got = AK.affine_level(_affine_rows2(q1), _affine_rows2(q2))
    assert torch.equal(got, _affine_rows2([a + b for a, b in zip(q1, q2)]))
    assert calls[1:] == [(1, FQ.L)]  # G2 inverts its Fq norms
    for fops, grp in ((W.G1Ops, G1), (W.G2Ops, G2)):
        enc = W.encode_g1_points if fops is W.G1Ops else W.encode_g2_points
        dec = W.decode_affine_g1 if fops is W.G1Ops else W.decode_affine_g2
        pts = [grp.generator() * k for k in (3, 5, 9)]
        X, Y, Z = (torch.as_tensor(np.asarray(c).astype(np.int32)) for c in enc(pts))
        assert dec(*W.to_affine(fops, (X, Y, Z))) == pts
    assert calls[2:] == [(1, FQ.L), (1, FQ.L)]
    F.tree_batch_inv(FQ, got[:, :FQ.L], lambda x, y: F.mont_mul(FQ, x, y))
    assert calls[4:] == [(1, FQ.L)]


# --- the adds' schedule ---------------------------------------------------------

def _scheduled_add(grp, p, q, leaf01=False):
    """RCB'15 Algorithm 7 on host projective coordinates of G1 (Fq) or G2
    (Fq2) through the kernel's tables, one step at a time; b3 = 3 b (12 on
    G1, 12(1 + u) on G2). ``leaf01`` (every Z is 0 or 1): threads 2, 4 and
    5 of layer 1 write their selects, and the linear step reads LEAF_LIN."""
    b3 = grp.B + grp.B + grp.B
    zero = grp.B - grp.B
    pa, qa = list(p) + [zero], list(q) + [zero]
    P = [(pa[u] + pa[v]) * (qa[u] + qa[v]) for u, v in PA.ADD_L1] + [zero]
    if leaf01:
        live1, live2 = p[2] != zero, q[2] != zero
        one = Fq2(1, 0) if grp is G2 else type(zero)(1)
        P[2] = one if live1 and live2 else zero
        for j in (4, 5):
            u = PA.ADD_L1[j][0]
            P[j] = (pa[u] if live2 else zero) + (qa[u] if live1 else zero)
    O = []
    for d, s, beta, a, b, c in PA.LEAF_LIN if leaf01 else PA.ADD_LIN:
        inner = P[a] - P[b] - P[c]
        inner = b3 * inner if beta else inner
        O.append(P[d] + inner if s > 0 else P[d] - inner)
    Qs = [O[a] * O[b] for a, b in PA.ADD_L2]
    return tuple(Qs[a] + Qs[b] if s > 0 else Qs[a] - Qs[b] for a, b, s in PA.ADD_OUT)


def _case(grp, name):
    rng = random.Random(63)
    g = grp.generator()
    P, Qp = g * rng.randrange(1, R), g * rng.randrange(1, R)
    O = grp.identity()
    return {"P+Q": (P, Qp), "P+P": (P, P), "P+(-P)": (P, -P), "O+P": (O, P), "P+O": (P, O),
            "O+O": (O, O)}[name]


def _host_coords(group, rows):
    """(1, 3K) rows -> the host field's X, Y, Z (Fq elements of G1.B's type
    on G1, Fq2 on G2)."""
    if group == 1:
        return [type(G1.B)(W.FqOps.decode(c)[0]) for c in unpack_rows(1, rows)]
    return [Fq2(*W.Fq2Ops.decode(c)[0]) for c in unpack_rows(2, rows)]


CASES = ["P+Q", "P+P", "P+(-P)", "O+P", "O+O"]
LEAF_CASES = CASES + ["P+O"]


# the complete add's G2 cases keep their ids from before the schedule covered
# G1 and the leaf form; the leaf's operands are encoded affine (Z in {0, 1})
@pytest.mark.parametrize(
    "group,case,leaf01",
    [(2, c, False) for c in CASES] + [(1, c, False) for c in CASES]
    + [(g, c, True) for g in (2, 1) for c in LEAF_CASES],
    ids=CASES + [f"G1-{c}" for c in CASES] + [f"{g}leaf-{c}" for g in ("", "G1-") for c in LEAF_CASES])
def test_g2_schedule_matches_host_addition(group, case, leaf01):
    """The schedule gives the host sum, and the same projective values as
    the plain version of the kernel (so the same limbs: every step is fully
    reduced), on G2 and on G1, in the complete and the leaf form."""
    grp = G1 if group == 1 else G2
    enc = W.encode_g1_points if group == 1 else W.encode_g2_points
    a, b = _case(grp, case)
    rows = [torch.as_tensor(np.concatenate([np.asarray(c).reshape(1, -1) for c in enc([pt])],
                                           axis=1).astype(np.int32)) for pt in (a, b)]
    X3, Y3, Z3 = _scheduled_add(grp, *(_host_coords(group, r) for r in rows), leaf01=leaf01)
    want = a + b
    if want.is_identity():
        assert Z3 == grp.B - grp.B
    else:
        zi = Z3.invert()
        assert grp.from_xy(X3 * zi, Y3 * zi) == want
    plain = PA.point_add_plain(group, rows[0], rows[1], leaf01)
    assert _host_coords(group, plain) == [X3, Y3, Z3]


def _cuda_table(src, name):
    body = re.search(name + r"(?:\[\d+\])+ = \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [int(x) for x in re.findall(r"-?\d+", body)]


def test_g2_schedule_matches_cuda_source():
    """The five tables agree with the .cu, which holds one copy of each and
    one kernel template that both groups' complete and leaf adds
    instantiate."""
    src = (CSRC / "point_add.cu").read_text()
    for name in ("ADD_L1", "ADD_LIN", "LEAF_LIN", "ADD_L2", "ADD_OUT"):
        table = getattr(PA, name)
        assert len(re.findall(r"__constant__ int " + name + r"\[", src)) == 1, name
        assert _cuda_table(src, name) == [v for row in table for v in row], name
    assert "G2_" not in src
    for e in ("FqE", "Fq2E"):
        for leaf in ("false", "true"):
            assert f"launch_group<{e}, {leaf}>" in src
    assert len(re.findall(r"__global__", src)) == 1  # group_add_kernel<E, LEAF>
    assert "point_add_kernel" not in src


# --- the Edwards add's and the fold's layers ----------------------------------------------

_RF = FR.modulus
_RF_INV = pow(FR.R_mod, -1, _RF)


def _run_layers(layers, slots):
    """A schedule of kernels/jubjub.py on Montgomery-form ints, one row after
    another: the kernel's threads in some order (a layer's rows are
    independent)."""
    for kind, rows in layers:
        for row in rows:
            if kind == "mul":
                out, a, b = row
                slots[out] = slots[a] * slots[b] * _RF_INV % _RF
            else:
                out, x, sign, y, z = row
                t = slots[y] if z == KJ.NONE else (slots[y] + slots[z]) % _RF
                slots[out] = (slots[x] + sign * t) % _RF
    return slots


@functools.cache
def _order8():
    """A point of order 8: a decoded point times the subgroup order."""
    rng = random.Random(8)
    while True:
        p = ExtendedPoint.from_bytes(rng.randbytes(32))
        t = None if p is None else p.mul_scalar_int(JubjubFr.META.modulus)
        if t is not None and not t.mul_scalar_int(4).is_identity():
            return t


def _edwards_case(name):
    rng = random.Random(67)
    g = spending_key_generator()
    P, Qp = (g.mul_scalar_int(rng.randrange(1, JubjubFr.META.modulus)) for _ in range(2))
    O, t8 = ExtendedPoint.identity(), _order8()
    return {"P+Q": (P, Qp), "P+P": (P, P), "P+(-P)": (P, -P), "O+P": (O, P), "O+O": (O, O),
            "T2+P": (t8.mul_scalar_int(4), P), "T4+T8": (t8.mul_scalar_int(2), t8), "T8+T8": (t8, t8)}[name]


def _edwards_rows(point, lam):
    """(1, 48) rows of ``point`` as (lam u : lam v : lam)."""
    u, v = point.to_affine()
    vals = [u.n * lam % _RF, v.n * lam % _RF, lam % _RF]
    return torch.as_tensor(np.concatenate([F.encode(FR, [x]) for x in vals], axis=1).astype(np.int32))


def _raw(rows):
    """(n, 16 k) Montgomery limb rows -> n lists of k stored ints."""
    k = rows.shape[1] // FR.L
    cols = [F.decode(FR, rows[:, FR.L * i : FR.L * (i + 1)], mont=False) for i in range(k)]
    return [list(v) for v in zip(*cols)]


def _word_ints(words):
    """(32,) fold-table words -> its FOLD_ENTRY stored ints."""
    w = np.asarray(words).astype(np.uint32).astype(object)
    return [sum(int(w[8 * e + j]) << (32 * j) for j in range(8)) for e in range(KJ.FOLD_ENTRY)]


EDWARDS_CASES = ["P+Q", "P+P", "P+(-P)", "O+P", "O+O", "T2+P", "T4+T8", "T8+T8"]


@pytest.mark.parametrize("form,case", [(f, c) for f in ("add", "mixed") for c in EDWARDS_CASES] + [("fold", "172")],
                         ids=[f"{f}-{c}" for f in ("add", "mixed") for c in EDWARDS_CASES] + ["fold-172"])
def test_edwards_schedule(form, case):
    """The layers of jubjub_add_kernel (ADD_LAYERS: the complete add, the
    first operand with general Z) and of pedersen_fold_kernel's step
    (FOLD_LAYERS: the mixed add of a fold-table entry, Z2 = 1) give the
    limbs of edwards_add over mont_mul_plain and the host curve's sum, on
    generic points, doubling, inverses, the identity and points of order 2,
    4 and 8; and the fold's steps over fold_table's layout of the Merkle
    hash's 172-chunk table give pedersen_fold_plain's limbs."""
    slots = [0] * (KJ.FOLD_NS + KJ.FOLD_ENTRY)
    if form == "fold":
        table = PED._chunk_tables(172, "cpu")
        words = KJ.fold_table(table).numpy()
        idx = np.random.default_rng(13).integers(0, 9, (172, 3), dtype=np.int32)
        want = _raw(KJ.pedersen_fold_plain(table, torch.as_tensor(idx)))
        for h in range(idx.shape[1]):
            slots[:3] = [0, FR.R_mod % _RF, FR.R_mod % _RF]
            for c in range(idx.shape[0]):
                slots[KJ.FOLD_NS :] = _word_ints(words[c, idx[c, h]])
                _run_layers(KJ.FOLD_LAYERS, slots)
            assert slots[:3] == want[h]
        return
    a, b = _edwards_case(case)
    p = _edwards_rows(a, 0x1234567)
    q = _edwards_rows(b, 1 if form == "mixed" else 0x89ABCDE)
    want = _raw(KJ.jubjub_add_plain(p, q))[0]
    if form == "add":
        slots[:6] = _raw(p)[0] + _raw(q)[0]
        slots[KJ.ADD_NS] = F.decode(FR, KJ.D_MONT[None], mont=False)[0]
        got = _run_layers(KJ.ADD_LAYERS, slots)[KJ.ADD_OUT : KJ.ADD_OUT + 3]
    else:
        slots[:3] = _raw(p)[0]
        slots[KJ.FOLD_NS :] = _word_ints(KJ.fold_table(q.expand(9, -1).reshape(1, 9, 48))[0, 0].numpy())
        got = _run_layers(KJ.FOLD_LAYERS, slots)[:3]
    assert got == want
    X, Y, Z = got
    zi = pow(Z, -1, _RF)
    assert (X * zi % _RF, Y * zi % _RF) == tuple(c.n for c in (a + b).to_affine())


_EDWARDS_TABLES = {"ADD": ["LIN0", "L1", "LIN1", "L2", "L3", "LIN2", "L4"],
                   "FOLD": ["LIN0", "L1", "LIN1", "L2", "LIN2", "L3"]}


def test_edwards_schedule_matches_cuda_source():
    """csrc/jubjub.cu holds kernels/jubjub.py's tables and slot counts, its
    two layered kernels run the layers in ADD_LAYERS' and FOLD_LAYERS'
    order, its carry-chain product's constants are Fr's modulus words, and
    fr_sqrt_kernel runs the carry-chain fr_mul and fr_sqr, not field.cuh's
    fe_mul."""
    src = (CSRC / "jubjub.cu").read_text()
    for form, names in _EDWARDS_TABLES.items():
        layers = getattr(KJ, form + "_LAYERS")
        assert [rows for _, rows in layers] == [getattr(KJ, f"{form}_{n}") for n in names]
        for name in names:
            body = re.search(form + "_" + name + r"\[\d+\]\[\d+\] = \{(.*?)\};", src, re.S).group(1)
            body = re.sub(r"//[^\n]*", "", body).replace("NONE", str(KJ.NONE))
            assert [int(x) for x in re.findall(r"-?\d+", body)] == [v for row in getattr(KJ, f"{form}_{name}")
                                                                    for v in row], name
        kernel = src[src.index("jubjub_add_kernel(" if form == "ADD" else "pedersen_fold_kernel("):]
        kernel = kernel[: kernel.index("\n}\n")]
        rows_of = {}  # each Rows variable: (table, its rows, its width)
        for count, width, decls in re.findall(r"Rows<(\d+), (\d)> ([^;]*);", kernel):
            for var, table in re.findall(r"(\w+)\(" + form + r"_(\w+), t\)", decls):
                rows_of[var] = (table, int(count), int(width))
        calls = [(kind, rows_of[var]) for kind, var in re.findall(r"(lin|mul)_layer<" + form + r"_NS>\((\w+),", kernel)]
        assert calls == [(kind, (n, len(rows), 3 if kind == "mul" else 5)) for (kind, rows), n in zip(layers, names)]
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert (int(consts["NONE"]), int(consts["ADD_NS"]), int(consts["FOLD_NS"]), int(consts["ADD_OUT"])) == (
        KJ.NONE, KJ.ADD_NS, KJ.FOLD_NS, KJ.ADD_OUT)
    words = {int(k): int(v, 16) for k, v in re.findall(r"FR_W(\d) = (0x[0-9a-f]+)u", src)}
    assert sum(words[j] << (32 * j) for j in range(8)) == _RF and len(words) == 8
    sqrt = src[src.index("fr_sqrt_kernel("): src.index("#ifdef MASP_JUBJUB_PROBE")]
    assert "fe_mul(" not in sqrt and "fr_mul(" in sqrt and "fr_sqr(" in sqrt


def test_sqrt_window_matches_cuda_source():
    """csrc/jubjub.cu walks the square root's exponent by kernels/jubjub.py's
    window and digits, from the most significant digit, which is not 0."""
    src = (CSRC / "jubjub.cu").read_text()
    consts = dict(re.findall(r"constexpr int (SQRT_\w+) = ([^;]+);", src))
    assert int(consts["SQRT_WINDOW"]) == KJ.SQRT_WINDOW and int(consts["SQRT_NDIGITS"]) == len(KJ.SQRT_DIGITS)
    body = re.search(r"__constant__ int SQRT_DIGITS\[SQRT_NDIGITS\] = \{(.*?)\};", src, re.S).group(1)
    assert tuple(int(x) for x in re.findall(r"\d+", body)) == KJ.SQRT_DIGITS
    assert KJ.SQRT_DIGITS[0] != 0 and all(0 <= d < 1 << KJ.SQRT_WINDOW for d in KJ.SQRT_DIGITS)
    assert sum(d << (KJ.SQRT_WINDOW * i) for i, d in enumerate(KJ.SQRT_DIGITS[::-1])) == (KJ.T_ODD - 1) // 2


def _window_pow(a, mul, sqr):
    """a^((t - 1) / 2) by fr_sqrt_kernel's walk over SQRT_DIGITS: the table
    a^1 .. a^15, w = a^d0, then four squarings and, where d != 0, a product
    by a^d for each later digit."""
    table = [None, a, sqr(a)]
    for _ in range(3, 1 << KJ.SQRT_WINDOW):
        table.append(mul(table[-1], a))
    w = table[KJ.SQRT_DIGITS[0]]
    for d in KJ.SQRT_DIGITS[1:]:
        for _ in range(KJ.SQRT_WINDOW):
            w = sqr(w)
        if d:
            w = mul(w, table[d])
    return w


def test_sqrt_window_walk_on_host_ints():
    """The window walk gives a^((t - 1) / 2) on host ints for 0, 1, -1, the
    values of every 2-adic order and seeded values; its squarings and
    products, with the Tonelli-Shanks steps', are chip_smoke's count of the
    kernel's products (881, the bound's), 70 fewer than the bit-by-bit
    walk's 951."""
    import chip_smoke

    r, e = KJ._R, (KJ.T_ODD - 1) // 2
    count = {"sqr": 0, "mul": 0}

    def sqr(x):
        count["sqr"] += 1
        return x * x % r

    def mul(x, y):
        count["mul"] += 1
        return x * y % r

    vals = chip_smoke._two_adic_values(seed=5) + [random.Random(6).randrange(r) for _ in range(8)]
    for a in vals:
        assert _window_pow(a, mul, sqr) == pow(a, e, r)
    walk = {k: v // len(vals) for k, v in count.items()}
    assert walk == {"sqr": 1 + KJ.SQRT_WINDOW * (len(KJ.SQRT_DIGITS) - 1),
                    "mul": (1 << KJ.SQRT_WINDOW) - 3 + sum(1 for d in KJ.SQRT_DIGITS[1:] if d)}
    steps = KJ.sqrt_schedule()
    inner, bounds = sum(1 for j in steps if j), sum(1 for j in steps if not j)
    assert chip_smoke._sqrt_products() == (walk["sqr"] + 1 + inner + 2 * bounds + 1, walk["mul"] + 2 + 2 * bounds)
    assert sum(chip_smoke._sqrt_products()) == 881
    assert chip_smoke._sqrt_products_bitwise() == 951 == sum(chip_smoke._sqrt_products()) + 70


def _cuda_words(src, name):
    body = re.search(name + r"\[(\d+)\] = \{(.*?)\};", src, re.S)
    return int(body.group(1)), [int(x.rstrip("u"), 0) for x in re.findall(r"0x[0-9a-f]+u?|\d+", body.group(2))]


def test_inverse_constants_match_cuda_source():
    """The divstep inversion's constants in csrc/mont_mul.cu (N in signed
    30-bit limbs, N^-1 mod 2^30, R^3 mod N, the batch count) equal
    kernels/mont_mul.divstep_constants and the values they stand for; the
    Fermat chain's nibble tables and shared-memory table are gone."""
    src = (CSRC / "mont_mul.cu").read_text()
    inv = src[src.index("--- inversion"):]
    assert "__shared__" not in inv and "NIBBLES" not in src
    for spec, tag in ((FQ, "FQ"), (FR, "FR")):
        c = MK.divstep_constants(spec)
        n, bits = spec.modulus, spec.modulus.bit_length()
        k, n30 = _cuda_words(src, tag + "_N30")
        assert k == c.limbs == len(n30) and n30 == c.n30
        assert sum(x << (30 * i) for i, x in enumerate(n30)) == n and all(0 <= x < 1 << 30 for x in n30)
        assert 30 * c.limbs >= bits + 2  # |f|, |g| <= N and d, e in (-2N, N), with a sign
        w, r3 = _cuda_words(src, tag + "_R3")
        assert w == spec.L // 2 and sum(x << (32 * i) for i, x in enumerate(r3)) == c.r3 == pow(spec.R, 3, n)
        struct = re.search(r"struct Inv<" + spec.name + r"> \{(.*?)\};", inv, re.S).group(1)
        got = {m.group(1): int(m.group(2).rstrip("u"), 0)
               for m in re.finditer(r"static constexpr \w+ (\w+) = (0x[0-9a-f]+u?|\d+);", struct)}
        assert got == {"K": c.limbs, "BATCHES": c.batches, "NINV30": c.ninv30}
        assert c.ninv30 * n % (1 << 30) == 1
        assert c.steps == (49 * bits + 80) // 17 and 30 * (c.batches - 1) < c.steps <= 30 * c.batches
    assert (MK.divstep_constants(FQ).batches, MK.divstep_constants(FR).batches) == (37, 25)


def test_redesigned_wrappers_check_inputs():
    with pytest.raises(ValueError):
        MK.mont_inv(FQ, torch.zeros(4, 16, dtype=torch.int32))
    with pytest.raises(ValueError):
        MK.mont_inv(FQ, torch.zeros(4, 24, dtype=torch.int64))
    before = dict(LAUNCHES)
    MK.mont_inv(FQ, torch.zeros(2, 24, dtype=torch.int32))
    assert LAUNCHES == before
    with pytest.raises(ValueError):  # the fold kernel takes entries with Z = 1 only
        KJ.fold_table(torch.zeros(1, 9, 48, dtype=torch.int32))
