"""The inline-PTX carry chains of the CUDA sources run on host ints.

No CUDA compiler or card is needed: each ``asm`` statement of a device
function is read from the source text, its PTX integer instructions
(add/addc/sub/subc/mad/madc with .cc, .lo and .hi) executed on Python ints
with an explicit carry flag, and its operands bound to Python lists named as
in the C code. The C code around the statements (row loops, regrouping,
plain products) is repeated here line for line, and a digest of that code
for each function fails a test when the source changes under it. Checked: jubjub.cu's fr_mul
and fr_sqr against host Montgomery products (and fr_sqr against fr_mul), and
mont_mul_mxu.cu's warp (the wide product's chains, the m16n8k32 fragments of
kernels/mont_mul_mxu.fragments unpacked by the PTX fragment layouts, the
word-wide normalisation) against mont_mul_mxu_plain and host ints, on
reduced and on unreduced rows. The card runs the same code in chip_smoke.py
and tests/test_torch_card.py. Integer arithmetic: every comparison is
exact."""

import functools
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from masp_tpu_torch.kernels import mont_mul_mxu as MX
from masp_tpu_torch.ops.field import FQ, FR

CSRC = Path(__file__).resolve().parent.parent / "masp_tpu_torch" / "csrc"
M32 = (1 << 32) - 1


# --- the emulator ---------------------------------------------------------------------

def _body(src, head):
    """The brace-balanced body of the function whose text starts with head."""
    j = src.index("{", src.index(head))
    depth = 0
    for k in range(j, len(src)):
        depth += {"{": 1, "}": -1}.get(src[k], 0)
        if depth == 0:
            return src[j : k + 1]
    raise ValueError(head)


def _top_split(text, sep):
    """text split at sep outside parentheses and string literals."""
    out, depth, cur, quoted = [], 0, "", False
    for i, ch in enumerate(text):
        if ch == '"' and text[i - 1] != "\\":
            quoted = not quoted
        if not quoted:
            depth += {"(": 1, ")": -1, "[": 1, "]": -1}.get(ch, 0)
            if ch == sep and depth == 0:
                out.append(cur)
                cur = ""
                continue
        cur += ch
    return out + [cur]


class Asm:
    """One asm statement: its instructions and operands, compiled once."""

    def __init__(self, inner):
        parts = _top_split(inner, ":")
        text = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', parts[0])).replace("\\n", "").replace("\\t", "")
        self.code = []
        for line in filter(None, (x.strip() for x in text.split(";"))):
            op, args = line.split(None, 1)
            self.code.append((op.split("."), [a.strip() for a in args.split(",")]))
        self.ops = []
        for kind, part in (("out", parts[1]), ("in", parts[2] if len(parts) > 2 else "")):
            for item in filter(str.strip, _top_split(part, ",")):
                con, expr = re.match(r'\s*"([^"]*)"\s*\((.*)\)\s*$', item, re.S).groups()
                read = kind == "in" or "+" in con
                self.ops.append((read, kind == "out", compile(expr, expr, "eval"),
                                 compile(f"{expr} = _v", expr, "exec")))

    def __call__(self, env):
        v = [eval(code, env) & M32 if read else None for read, _, code, _ in self.ops]
        cf = None
        for parts, args in self.code:
            x = [v[int(a[1:])] if a.startswith("%") else int(a, 0) for a in args[1:]]
            cin = 0
            if parts[0] in ("addc", "subc", "madc"):
                assert cf is not None, "a carry read without a carry set in the same statement"
                cin = cf
            if parts[0] in ("add", "addc"):
                r = x[0] + x[1] + cin
                flag = r >> 32
            elif parts[0] in ("sub", "subc"):
                r = x[0] - x[1] - cin
                flag = int(r < 0)
            else:  # mad, madc
                prod = x[0] * x[1]
                r = (prod & M32 if "lo" in parts else prod >> 32) + x[2] + cin
                flag = r >> 32
            v[int(args[0][1:])] = r & M32
            cf = flag if "cc" in parts else None
        for (_, out, _, assign), val in zip(self.ops, v):
            if out:
                env["_v"] = val
                exec(assign, env)


@functools.cache
def statements(name, head):
    """The asm statements of the function starting with ``head`` in
    csrc/<name>, in source order."""
    body = _body((CSRC / name).read_text(), head)
    out = []
    for m in re.finditer(r"\basm\s*(?:volatile\s*)?\(", body):
        depth, k = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(body[k], 0)
            k += 1
        out.append(Asm(body[m.end() : k - 1]))
    return out


class View:
    """A pointer into a list, as acc = q + 3 in the C code."""

    def __init__(self, base, off):
        self.base, self.off = base, off

    def __getitem__(self, i):
        return self.base[self.off + i]

    def __setitem__(self, i, v):
        self.base[self.off + i] = v


def words(x, n):
    return [(x >> (32 * j)) & M32 for j in range(n)]


def value(ws):
    return sum(int(w) << (32 * j) for j, w in enumerate(ws))


# --- jubjub.cu: fr_mul and fr_sqr -------------------------------------------------------

_RF = FR.modulus
FR_W = {f"FR_W{j}": w for j, w in enumerate(words(_RF, 8))}


def _jub(head):
    return statements("jubjub.cu", head)


def fr_reduce(t):
    env = dict(FR_W, t=list(t), d=[0] * 8, borrow=0)
    _jub("void fr_reduce(")[0](env)
    return [t[j] if env["borrow"] else env["d"][j] for j in range(8)]


def fr_reduce_row(e, o, c):
    env = dict(FR_W, e=e, o=o, m=(0 - e[0]) & M32, c=c)
    for stmt in _jub("void fr_reduce_row("):
        stmt(env)


def fr_shift_sum(e, o):
    env = dict(t=[0] * 8, e=e, o=o)
    _jub("void fr_shift_sum(")[0](env)
    return env["t"]


def fr_mul(a, y):
    odd, even = _jub("void fr_mul(")
    e, o = [0] * 9, [0] * 9
    for k in range(4):
        e[2 * k], e[2 * k + 1] = (a[2 * k] * y[0]) & M32, (a[2 * k] * y[0]) >> 32
        o[2 * k], o[2 * k + 1] = (a[2 * k + 1] * y[0]) & M32, (a[2 * k + 1] * y[0]) >> 32
    for i in range(8):
        if i > 0:
            env = dict(a=a, b=y[i], e=e, o=o, O=[0] * 9)
            odd(env)
            E = [env["E0"]] + [0] * 8
            even(dict(a=a, b=y[i], o=o, E=E))
            e, o = E, env["O"]
        fr_reduce_row(e, o, 0)
    return fr_reduce(fr_shift_sum(e, o))


# sqr_row<K>(acc + off, a + x, a[b]) as fr_sqr calls them
SQR_ROWS = [(3, "q", 3, 2, 1), (3, "p", 4, 3, 1), (3, "q", 5, 3, 2), (2, "p", 6, 4, 2), (2, "q", 7, 4, 3),
            (2, "p", 8, 5, 3), (2, "q", 9, 5, 4), (1, "p", 10, 6, 4), (1, "q", 11, 6, 5), (1, "p", 12, 7, 5),
            (1, "q", 13, 7, 6)]


def fr_sqr(a):
    total, wide, regroup, top = _jub("void fr_sqr(")
    acc = {"p": [0] * 16, "q": [0] * 16}
    p, q = acc["p"], acc["q"]
    for j in range(1, 8):
        side = q if j & 1 else p
        side[j], side[j + 1] = (a[0] * a[j]) & M32, (a[0] * a[j]) >> 32
    for k, name, off, x, b in SQR_ROWS:
        _jub(f"void sqr_row<{k}>(")[0](dict(acc=View(acc[name], off), x=View(a, x), b=a[b]))
    total(dict(p=p, q=q))
    t = [(a[0] * a[0]) & M32, (q[1] << 1) & M32] + [((q[k] << 1) | (q[k - 1] >> 31)) & M32 for k in range(2, 16)]
    wide(dict(t=t, a=a))
    assert value(t) == value(a) ** 2
    e, o = t[:8] + [0], [0] * 9
    fr_reduce_row(e, o, 0)
    for _ in range(1, 8):
        env = dict(o=o, e=e)
        regroup(env)
        e, o = [env["E0"]] + o[1:8] + [0], e[2:9] + [o[8], 0]
        fr_reduce_row(e, o, env["c"])
    u = fr_shift_sum(e, o)
    top(dict(u=u, t=t))
    return fr_reduce(u)


def test_fr_sqr_calls_the_rows_emulated():
    """fr_sqr's sqr_row calls are SQR_ROWS, and they cover each cross
    product a_i a_j (i < j) once: row 0's plain products and rows 1 .. 6."""
    body = _body((CSRC / "jubjub.cu").read_text(), "void fr_sqr(")
    calls = re.findall(r"sqr_row<(\d)>\((\w) \+ (\d+), a \+ (\d+), a\[(\d)\]\);", body)
    assert [tuple(int(c) if c.isdigit() else c for c in call) for call in calls] == SQR_ROWS
    pairs = [(0, j) for j in range(1, 8)]
    pairs += [(b, x + 2 * i) for k, _, _, x, b in SQR_ROWS for i in range(k)]
    assert sorted(pairs) == [(i, j) for i in range(8) for j in range(i + 1, 8)]
    for k, name, off, x, b in SQR_ROWS:  # the chain starts at a_b a_x's position, odd in q, even in p
        assert off == b + x and (off % 2 == 1) == (name == "q")


def _fr_values(seed, n):
    rng = random.Random(seed)
    edge = [0, 1, 2, _RF - 1, _RF - 2, (1 << 255) % _RF, (1 << 256) % _RF, ((1 << 256) - 1) % _RF]
    edge += [int("ffffffff" * k, 16) % _RF for k in range(1, 9)] + [_RF - (1 << k) for k in (0, 31, 32, 64, 200)]
    return edge + [rng.randrange(_RF) for _ in range(n)]


@pytest.mark.parametrize("seed", [1, 2])
def test_fr_sqr_and_fr_mul_match_host_ints(seed):
    rinv = pow(1 << 256, -1, _RF)
    rng = random.Random(seed + 10)
    for x in _fr_values(seed, 12):
        want = x * x * rinv % _RF
        assert value(fr_sqr(words(x, 8))) == want, hex(x)
        assert value(fr_mul(words(x, 8), words(x, 8))) == want
        y = rng.randrange(_RF)
        assert value(fr_mul(words(x, 8), words(y, 8))) == x * y * rinv % _RF


# --- mont_mul_mxu.cu: one warp ---------------------------------------------------------------

TW, LZ = 12, 52


def _mxu(head):
    return statements("mont_mul_mxu.cu", head)


def wide_mul(a, y):
    odd, even, top = _mxu("void wide_mul(")
    e, o = [0] * 13, [0] * 13
    for k in range(6):
        e[2 * k], e[2 * k + 1] = (a[2 * k] * y[0]) & M32, (a[2 * k] * y[0]) >> 32
        o[2 * k], o[2 * k + 1] = (a[2 * k + 1] * y[0]) & M32, (a[2 * k + 1] * y[0]) >> 32
    T = [e[0]] + [0] * 23
    for i in range(1, TW):
        env = dict(O=e[2:13] + [o[12], 0], o=o, e=e, a=a, b=y[i])
        odd(env)
        E = [env["E0"]] + o[1:12] + [0]
        even(dict(E=E, a=a, b=y[i]))
        T[i] = E[0]
        e, o = E, env["O"]
    top(dict(e=e, o=o))
    return T[:TW] + e[1:13]


def _bytes(w):
    return [(int(w) >> (8 * q)) & 0xFF for q in range(4)]


@functools.cache
def _a_tiles():
    """{(matrix, mt, ks): the 16 x 32 A tile} unpacked from the wrapper's
    fragments by the PTX m16n8k32 .u8 A layout: byte i of lane 4g + t sits
    in register i / 4 at row g (i < 4 or 8 <= i < 12, else g + 8) and column
    4t + i % 4 (+ 16 from i = 8 on)."""
    tiles = {}
    for name, A in zip((1, 2), MX.unsigned_toeplitz(MX.mxu_consts(FQ))):
        for (mt, ks), frag in zip(MX.band_blocks(A.shape[0]), MX.fragments(A)):
            tile = np.zeros((16, 32), dtype=np.int64)
            for lane in range(32):
                g, t = divmod(lane, 4)
                for i in range(16):
                    row = g if (i < 4 or 8 <= i < 12) else g + 8
                    tile[row, 4 * t + i % 4 + (16 if i >= 8 else 0)] = _bytes(frag[lane, i // 4])[i % 4]
            tiles[name, mt, ks] = tile
    return tiles


def _band(mt, ks):
    return 32 * ks <= 16 * mt + 15 and 16 * mt <= min(32 * ks + 31, 47) + 47


def const_dot(name, mt0, cols, lazy):
    """const_dot<MT0>: per m-tile and n-tile the kernel's B fragments
    (words 8 ks + t and 8 ks + 4 + t of column 8 nt + g; 0 for the padding)
    through the PTX B layout (byte i of lane 4g + t at row 4t + i % 4, + 16
    from i = 4 on, column g), D = A B scattered by the D layout (lane 4g + t:
    (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1)) as the kernel stores it."""
    for mt in range(mt0, mt0 + 3):
        for nt in range(4):
            D = np.zeros((16, 8), dtype=np.int64)
            for ks in (0, 1):
                if not _band(mt, ks):
                    continue
                B = np.zeros((32, 8), dtype=np.int64)
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    col = cols[8 * nt + g]
                    regs = (col[t], col[4 + t]) if ks == 0 else (col[8 + t], 0)
                    for i in range(8):
                        B[4 * t + i % 4 + (16 if i >= 4 else 0), g] = _bytes(regs[i // 4])[i % 4]
                D += _a_tiles()[name, mt, ks] @ B
            for lane in range(32):
                g, t = divmod(lane, 4)
                e, k = 8 * nt + 2 * t, 16 * (mt - mt0) + g
                lazy[e][k], lazy[e + 1][k] = int(D[g, 2 * t]), int(D[g, 2 * t + 1])
                lazy[e][k + 8], lazy[e + 1][k + 8] = int(D[g + 8, 2 * t]), int(D[g + 8, 2 * t + 1])


def lazy_word(col, j):
    v = col[4 * j : 4 * j + 4]
    assert all(0 <= x < 1 << 22 for x in v)
    return v[0] + (v[1] << 8) + (v[2] << 16) + (v[3] << 24)


def mxu_warp(xs, ys):
    """mont_mul_mxu_kernel's steps 2-5 for one warp of 32 rows (ints)."""
    Ts = [wide_mul(words(x, TW), words(y, TW)) for x, y in zip(xs, ys)]
    for T, x, y in zip(Ts, xs, ys):
        assert value(T) == x * y
    cols = [T[:TW] for T in Ts]
    lazy = [[0] * LZ for _ in range(32)]
    const_dot(1, 0, cols, lazy)
    for lane in range(32):
        c, m = 0, []
        for j in range(TW):
            s = lazy_word(lazy[lane], j) + c
            m.append(s & M32)
            c = s >> 32
        cols[lane] = m
    const_dot(2, 0, cols, lazy)
    carry = []
    for lane in range(32):
        c = 0
        for j in range(TW):
            c = (lazy_word(lazy[lane], j) + Ts[lane][j] + c) >> 32
        carry.append(c)
    const_dot(2, 3, cols, lazy)
    out = []
    for lane in range(32):
        c, hi = carry[lane], []
        for j in range(TW):
            s = lazy_word(lazy[lane], j) + Ts[lane][TW + j] + c
            hi.append(s & M32)
            c = s >> 32
        h = value(hi)
        out.append(h - FQ.modulus if h >= FQ.modulus else h)
    return out


def test_mxu_band_matches_cuda_source():
    """mont_mul_mxu.cu's band blocks are kernels/mont_mul_mxu.band_blocks
    (4 of A1's 6 blocks, 9 of A2's 12), and its strides are the emulated ones."""
    src = (CSRC / "mont_mul_mxu.cu").read_text()
    assert re.search(r"return 32 \* ks <= 16 \* mt \+ 15 && 16 \* mt <= \(32 \* ks \+ 31 < 47 \? 32 \* ks \+ 31 : 47\)"
                     r" \+ 47;", src)
    assert [b for b in MX.band_blocks(96) if _band(*b)] == MX.band_blocks(96) == [
        (mt, ks) for mt in range(6) for ks in (0, 1) if _band(mt, ks)]
    assert (len(MX.band_blocks(48)), len(MX.band_blocks(96))) == (4, 9)
    consts = dict(re.findall(r"constexpr int (TW|LZ) = (\d+);", src))
    assert (int(consts["TW"]), int(consts["LZ"])) == (TW, LZ)


@pytest.mark.parametrize("rows", ["reduced", "unreduced"])
def test_mxu_warp_matches_plain(rows):
    """One warp through the emulated kernel against mont_mul_mxu_plain: on
    reduced rows (0, 1, q - 1 and R mod q among them; also against host
    Montgomery products) and on unreduced 16-bit limbs (the tool's timing
    inputs, where the dropped top carry shows)."""
    q, rng = FQ.modulus, random.Random(7)
    if rows == "reduced":
        xs = [0, 1, q - 1, FQ.R_mod % q] + [rng.randrange(q) for _ in range(28)]
        ys = [q - 1, 0, 1, q - 1] + [rng.randrange(q) for _ in range(28)]
    else:
        xs = [(1 << 384) - 1] + [rng.randrange(1 << 384) for _ in range(31)]
        ys = [(1 << 384) - 1] + [rng.randrange(1 << 384) for _ in range(31)]

    def limbs(vals):
        return torch.as_tensor(np.array([[(v >> (16 * j)) & 0xFFFF for j in range(FQ.L)] for v in vals], np.int32))

    want = MX.mont_mul_mxu_plain(FQ, limbs(xs), limbs(ys)).numpy()
    got = mxu_warp(xs, ys)
    assert got == [sum(int(v) << (16 * j) for j, v in enumerate(r)) for r in want]
    if rows == "reduced":
        rinv = pow(1 << 384, -1, q)
        assert got == [x * y * rinv % q for x, y in zip(xs, ys)]


# --- the C code around the asm statements ----------------------------------------------

def glue(name, head):
    """The body of the function starting with ``head`` in csrc/<name> with
    its comments dropped, each asm statement cut to ``asm;`` and the
    whitespace collapsed: the C code that the emulation above repeats."""
    body = re.sub(r"//[^\n]*|/\*.*?\*/", "", _body((CSRC / name).read_text(), head), flags=re.S)
    out, k = "", 0
    for m in re.finditer(r"\basm\s*(?:volatile\s*)?\(", body):
        if m.start() < k:
            continue
        depth, j = 1, m.end()
        while depth:
            depth += {"(": 1, ")": -1}.get(body[j], 0)
            j += 1
        out += body[k : m.start()] + "asm"
        k = j
    return " ".join((out + body[k:]).split())


# sha256 of glue() of each function whose C code the emulation repeats
# (fr_shift_sum and sqr_row<K> are asm alone, run whole from the source); a
# change to one of them fails here until the emulation has been brought in
# step and the digest renewed
GLUE = {
    ("jubjub.cu", "void fr_reduce("): "65e893eb77d91300ef3741c67220fd1d654a92fab50faecbae1478faccab3550",
    ("jubjub.cu", "void fr_reduce_row("): "6ec45969aa65d7480cfb3fa8ec02ed93d979e379c60d966f2088140e4999a673",
    ("jubjub.cu", "void fr_mul("): "b2f2ac51ed4c5a3a95c0b28491c44bd5b3d2d0b3516b02fa5e3231dc195023e9",
    ("jubjub.cu", "void fr_sqr("): "565b235ba470d30216ce3db963a0996972c92c9cde43c510b5c0b9b2289b6630",
    ("mont_mul_mxu.cu", "void const_dot("): "ad5df509cae0fc0cf5515087b55123a9b9df5a276e983a3edd69a00d54d52cf3",
    ("mont_mul_mxu.cu", "uint64_t lazy_word("): "863c2fa7d7f8f62faac24cc72dacf5aacee6744461ed924996a7c53d24d92fd0",
    ("mont_mul_mxu.cu", "void wide_mul("): "e0468b9e2501a2d045e224e355dc200c4a64bb6ca5ab738c7bf6df19c5d36736",
    ("mont_mul_mxu.cu", "void put_column("): "4b451c778dd6765153fb2c6b4b5ff34493c239b8a6fcfb438aad156358566d4e",
    ("mont_mul_mxu.cu", "\nmont_mul_mxu_kernel("): "65cacae15c0bc5593d23639ef88ea64b76cac8fc3c7a2e0365fd34792f8e7f7c",
}


@pytest.mark.parametrize("name, head", sorted(GLUE))
def test_emulated_c_code_is_unchanged(name, head):
    """The C code around each emulated function's asm statements is the code
    the emulation repeats: the emulated functions of jubjub.cu and
    mont_mul_mxu.cu, whose asm text the tests above run from the source."""
    import hashlib

    assert hashlib.sha256(glue(name, head).encode()).hexdigest() == GLUE[name, head], (
        f"the C code of {head.strip()} in {name} changed: bring its emulation in this file in step, then GLUE")


def test_emulator_flags_and_chains():
    """The emulator's own semantics: carries and borrows across words, .hi
    and .lo, and a carry read without one set is refused."""
    add = Asm('"add.cc.u32 %0, %2, %3;\\n\\t" "addc.u32 %1, 0, 0;" : "=r"(s), "=r"(c) : "r"(x), "r"(y)')
    env = dict(x=M32, y=5)
    add(env)
    assert (env["s"], env["c"]) == (4, 1)
    sub = Asm('"sub.cc.u32 %0, %2, %3;\\n\\t" "subc.u32 %1, 0, 0;" : "=r"(d), "=r"(b) : "r"(x), "r"(y)')
    env = dict(x=3, y=5)
    sub(env)
    assert (env["d"], env["b"]) == ((3 - 5) & M32, M32)
    mad = Asm('"mad.hi.cc.u32 %0, %1, %1, %2;" : "=r"(h) : "r"(x), "r"(z)')
    env = dict(x=M32, z=1)
    mad(env)
    assert env["h"] == ((M32 * M32) >> 32) + 1
    with pytest.raises(AssertionError):
        Asm('"addc.u32 %0, %1, 0;" : "=r"(s) : "r"(x)')(dict(x=1))
