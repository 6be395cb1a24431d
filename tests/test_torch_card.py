"""Every CUDA kernel of the port against its plain PyTorch version on the
card, bit for bit (integer arithmetic: the tolerance is exact equality), at
small widths (1, 3, 32, 1003; the point adds, G1, G2 and Jubjub, also at
17, one pair past a block, and 128, the widest bucket chain; the Jubjub
add also on the 8 pairs of every addition case, and on unaligned rows at
every width; the Pedersen fold also at 64 and 4,096 hashes, the tree's
narrowest level and the timed width; the inversion also at 2, and against
the Fermat chain and host ints; the square root with the values of every
2-adic order first; the tensor-core product with the raw rows 0, 1, q - 1
first, also against the mont_mul kernel; the int8 loop at k = 0 to 32768
on both ranges and ragged shapes) with the edge lanes first. The
Montgomery product runs at each width in every operand
form of the main path (strided and broadcast views, read in place) and on
unaligned rows. One case proves a tiny circuit on the card and holds the
proof against the port's CPU proof of the same witness, and one proves it
on a virtual mesh of two positions of the card (create_proof_from_assembly
(mesh=)); one holds the signed digits and the signed sorted MSM on the card
against their CPU runs; one proves a tiny circuit through each of the
prover's five off-by-default routes on the card against the CPU proof, and
holds the BGMW table and the batched sorted MSM against their CPU runs; one
holds the port's AEAD (host/crypto.py) against RFC 8439 and the note scan's device
decompression (SaplingDomain.batch_epk at 64 encodings) against the host.

This file imports neither jax nor masp_tpu, so it runs where only the port
is installed; every test is marked ``cuda`` and skips without a card. Run it
on a machine with one (the repository's tests/conftest.py imports jax, so
skip it there):

    python -m pytest --noconftest tests/test_torch_card.py -q

Inputs come from the port's host curve (masp_tpu_torch.host) and numpy
seeds. Each kernel's launch counter must rise by the launches made. One
test runs every case and names each one that fails.
"""

import random

import numpy as np
import pytest
import torch

from masp_tpu_torch import groth16 as TG
from masp_tpu_torch.groth16 import prover as TP
from masp_tpu_torch.groth16 import synthesis as S
from masp_tpu_torch.host.bls12_381 import G1, G2
from masp_tpu_torch.host.crypto import ChaCha20Poly1305
from masp_tpu_torch.host.fields import SCALAR_MODULUS, JubjubFr, Scalar
from masp_tpu_torch.host.jubjub import ExtendedPoint
from masp_tpu_torch.host.note_encryption.sapling_domain import SaplingDomain
from masp_tpu_torch.host.primitives.consensus import TEST_NETWORK
from masp_tpu_torch.host.primitives.constants import spending_key_generator
from masp_tpu_torch.host.r1cs.cs import ONE, KeypairAssembly, lc_var
from masp_tpu_torch.host.structures import prepare_verifying_key
from masp_tpu_torch.host.verifier import verify_proof
from masp_tpu_torch.kernels import LAUNCHES
from masp_tpu_torch.kernels import affine as AK
from masp_tpu_torch.kernels import int8_dot as I8
from masp_tpu_torch.kernels import jubjub as KJ
from masp_tpu_torch.kernels import mont_mul as MK
from masp_tpu_torch.kernels import mont_mul_mxu as MX
from masp_tpu_torch.kernels import point_add as PA
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops import jubjub as J
from masp_tpu_torch.ops import pedersen as PED
from masp_tpu_torch.ops import weierstrass as W
from masp_tpu_torch.ops.field import FQ, FR

WIDTHS = [1, 3, 32, 1003]
ADD_WIDTHS = [1, 3, 17, 32, 128, 1003]
INV_WIDTHS = [1, 2, 3, 32, 1003]
SPECS = {"Fr": FR, "Fq": FQ}
GROUPS = {1: (G1, W.encode_g1_points), 2: (G2, W.encode_g2_points)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _launched(name, fn, times=1):
    """fn(), checking that it launched kernel ``name`` ``times`` times."""
    before = LAUNCHES[name]
    out = fn()
    assert LAUNCHES[name] == before + times, name
    return out


def _field_rows(spec, width, seed, dev):
    """(width, L) Montgomery rows: 0, 1, N - 1, 2, N - 2, then seeded values."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 62, size=(width, 7), dtype=np.int64)
    vals = [0, 1, spec.modulus - 1, 2, spec.modulus - 2]
    vals += [int("".join(f"{int(w):016x}" for w in row), 16) % spec.modulus for row in words]
    return torch.as_tensor(F.encode(spec, vals[:width]).astype(np.int32), device=dev)


def _mont_mul_forms(x, y, width, form):
    """Operands of ``width`` products in one of the main path's forms (on
    rows x of 2 width and y of width): contiguous, an NTT stage's odd half
    (stride 2L a row, or h rows a butterfly group) with twiddles broadcast,
    a scalar in either order, a tree step's halves, and rows whose base and
    stride are not 16-byte aligned (the kernel's 4-byte loads)."""
    L = x.shape[1]
    if form.startswith("stage"):
        h = int(form[6:])
        return x.view(width // h, 2, h, L)[:, 1], y[:h][None].expand(width // h, h, L)
    if form == "scalar":
        return x[:width], y[width // 2].expand(width, L)
    if form == "scalar first":
        return y[width // 2].expand(width, L), x[:width]
    if form == "tree step":
        return x[:width], x[width:]
    if form == "unaligned":
        wide = torch.cat([y[:, :1], y, y[:, :1]], dim=1)  # rows of L + 2 limbs
        return wide[:, 1 : L + 1], x[::2]
    return x[:width], y.flip(0).contiguous()


def mont_mul_forms(width):
    """The forms at ``width``: the stage form with h = 1, with h = width and
    with a middle h that divides it."""
    hs = sorted({1, width} | {h for h in (4, 17) if width % h == 0})
    return ["contiguous", "scalar", "scalar first", "tree step", "unaligned"] + [f"stage {h}" for h in hs]


def check_mont_mul(dev, name, width, form):
    spec = SPECS[name]
    x = _field_rows(spec, 2 * width, 1, dev)
    y = _field_rows(spec, width, 2, dev)
    a, b = _mont_mul_forms(x, y, width, form)
    got = _launched("mont_mul_" + name.lower(), lambda: MK.mont_mul(spec, a, b))
    assert got.is_contiguous() and got.shape == a.shape
    want = MK.mont_mul_plain(spec, a.reshape(-1, spec.L), b.reshape(-1, spec.L))
    assert torch.equal(got.reshape(-1, spec.L), want)


def check_mont_inv(dev, name, width):
    """The divstep kernel against its plain version, the Fermat chain over
    the plain product and host ints; the edge rows 0 (-> 0), mont-1, N - 1,
    2, N - 2 and the raw 1 first."""
    spec = SPECS[name]
    a = _field_rows(spec, width, 3, dev)
    if width > 5:
        a[5] = 0
        a[5, 0] = 1  # the raw 1: Montgomery value R^-1
    got = _launched("mont_inv_" + name.lower(), lambda: MK.mont_inv(spec, a))
    assert torch.equal(got, MK.mont_inv_plain(spec, a))
    assert torch.equal(got, MK.fermat_chain(spec, a, lambda x, y: MK.mont_mul_plain(spec, x, y)))
    assert F.decode(spec, got) == [pow(x, spec.modulus - 2, spec.modulus) for x in F.decode(spec, a)]


def _points(grp, n, seed):
    """n distinct points: a seeded multiple of the generator, then a chain of
    additions of the generator."""
    g = grp.generator()
    p = g * random.Random(seed).randrange(1, 1 << 64)
    out = []
    for _ in range(n):
        out.append(p)
        p = p + g
    return out


def _pairs(group, width, seed):
    """(P1, P2) host points, width lanes: identity + identity, P + P,
    P + (-P), identity + P, P + identity, then distinct chords."""
    grp = GROUPS[group][0]
    pts = _points(grp, 68, seed)
    O = grp.identity()
    p1 = [O, pts[0], pts[1], O, pts[2]] + pts[3:35]
    p2 = [O, pts[0], -pts[1], pts[3], O] + pts[35:67]
    reps = -(-width // len(p1))
    return (p1 * reps)[:width], (p2 * reps)[:width]


def _proj_rows(group, points, dev):
    coords = GROUPS[group][1](points)
    n = len(points)
    return torch.as_tensor(np.concatenate([np.asarray(c).reshape(n, -1) for c in coords], axis=1).astype(np.int32),
                           device=dev)


def check_point_add(dev, group, leaf01, width, mix=False):
    """The complete adds on projective operands (general Z) and the leaf
    adds on Z in {0, mont-1}, contiguous and strided (the ladder's even and
    odd views); the leaf also against the complete kernel, whose limbs it
    gives. ``mix``: identities at seeded rows of both operands, so that one
    warp holds O+O, O+P, P+O and P+P."""
    p1, p2 = _pairs(group, width, 10 + group)
    P, Q = _proj_rows(group, p1, dev), _proj_rows(group, p2, dev)
    if not leaf01:
        P = PA.point_add_plain(group, P, torch.roll(Q, 1, 0))
        P[0] = Q[0]  # identity + identity stays first
    if mix:
        rng = np.random.default_rng(40 + group)
        ident = _proj_rows(group, [GROUPS[group][0].identity()], dev)[0]
        P[torch.as_tensor(rng.random(width) < 0.3, device=dev)] = ident
        Q[torch.as_tensor(rng.random(width) < 0.3, device=dev)] = ident
    want = PA.point_add_plain(group, P, Q, leaf01)
    K = P.shape[1]
    pairs = torch.cat([P, Q], dim=1)
    name = f"g{group}_add01" if leaf01 else f"g{group}_add"
    assert torch.equal(_launched(name, lambda: PA.point_add(group, P, Q, leaf01)), want)
    assert torch.equal(_launched(name, lambda: PA.point_add(group, pairs[:, :K], pairs[:, K:], leaf01)), want)
    if leaf01:
        assert torch.equal(PA.point_add(group, P, Q), want)


def _aff_rows(group, points, dev, decoy=None):
    """Affine rows [x | y | f]: the identity as (0, mont-1) with f = 1, or
    at lane ``decoy`` f = 1 over lane 2's finite coordinates."""
    X, Y, Z = (np.asarray(c).reshape(len(points), -1) for c in GROUPS[group][1](points))
    f = (Z == 0).all(axis=1).astype(np.int64)[:, None]
    rows = np.concatenate([X, Y, f], axis=1)
    if decoy is not None and decoy < len(points):
        rows[decoy, :-1] = rows[2, :-1]
        rows[decoy, -1] = 1
    return torch.as_tensor(rows.astype(np.int32), device=dev)


def check_affine_pre_post(dev, group, width):
    """affine_pre and affine_post of G1 (49-word rows) and G2 (97), on
    contiguous and strided operands, with a flagged lane over finite
    coordinates; the edge lanes' codes and identity flags; the whole level
    where the width is a power of two."""
    p1, p2 = _pairs(group, width, 20 + group)
    r1, r2 = _aff_rows(group, p1, dev, decoy=5), _aff_rows(group, p2, dev)
    row = r1.shape[1]
    pairs = torch.cat([r1, r2], dim=1)
    s1, s2 = pairs[:, :row], pairs[:, row:]
    suffix = "" if group == 1 else "_g2"
    want = AK.affine_pre_plain(r1, r2)
    for a, b in ((r1, r2), (s1, s2)):
        got = _launched("affine_pre" + suffix, lambda: AK.affine_pre(a, b))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    n, norm, code = want
    assert code[:6].tolist() == [3, 8, 4, 1, 2, 1][:width]
    ninv = MK.mont_inv_plain(FQ, norm)
    out = AK.affine_post_plain(n, ninv, r1, r2, code)
    for a, b in ((r1, r2), (s1, s2)):
        assert torch.equal(_launched("affine_post" + suffix, lambda: AK.affine_post(n, ninv, a, b, code)), out)
    assert out[:5, -1].tolist() == [1, 0, 1, 0, 0][:width]
    if width & (width - 1) == 0:
        assert torch.equal(AK.affine_level(s1, s2), AK.affine_level_plain(r1, r2))


def check_int8_dot(dev, M):
    """(M, K) @ (K, 96) on the full signed range, K = 48 (the tools'), 37
    (not a multiple of 4) and 64 (the most the kernel takes). The loop at
    (M, K) @ (K, N) for (K, N) = (48, 96), (40, 90), (37, 90), (1, 96) and
    (64, 96), on the tools' unsigned and the full signed range, at k = 0, 1,
    S - 1, S + 1 (S rep slices), 8, 64, 4096 and 32768, where the unsigned
    sums pass 2^31 and wrap. At the widest M also 4 M rows, a grid of more
    CTAs than the card has SMs (each CTA then asks only for the shared
    memory its tiles use)."""
    rng = np.random.default_rng(30 + M)
    for K in (48, 37, 64):
        x = torch.as_tensor(rng.integers(-128, 128, (M, K), dtype=np.int8), device=dev)
        w = torch.as_tensor(rng.integers(-128, 128, (K, 96), dtype=np.int8), device=dev)
        assert torch.equal(_launched("int8_dot", lambda: I8.int8_dot(x, w)), I8.int8_dot_plain(x, w))
    slices = I8.CLUSTER
    shapes = [(M, K, N) for K, N in ((48, 96), (40, 90), (37, 90), (1, 96), (64, 96))]
    if M == max(WIDTHS):
        shapes += [(4 * M, 48, 96), (4 * M, 37, 90)]
    for rows, K, N in shapes:
        for lo, hi in ((0, 127), (-128, 128)):
            x = torch.as_tensor(rng.integers(lo, hi, (rows, K), dtype=np.int8), device=dev)
            w = torch.as_tensor(rng.integers(lo, hi, (K, N), dtype=np.int8), device=dev)
            for k in sorted({0, 1, slices - 1, slices + 1, 8, 64, 4096, 32768}):
                got = _launched("int8_dot_loop", lambda: I8.int8_dot_loop(x, w, k))
                assert torch.equal(got, I8.int8_dot_loop_plain(x, w, k)), (rows, K, N, lo, k)


def check_mont_mul_mxu(dev, width):
    """The tensor-core product against its plain version, mont_mul_plain and
    the mont_mul kernel; the raw rows 0, 1 and q - 1 first (then Montgomery
    rows of 0, 1, q - 1, ...), past which the second operand runs reversed.
    Also on the same rows as contiguous views one int32 into their buffer
    (not 16-byte aligned: the kernel's 4-byte staging)."""
    raw = torch.as_tensor(np.array([[(v >> (16 * j)) & 0xFFFF for j in range(FQ.L)]
                                    for v in (0, 1, FQ.modulus - 1)], dtype=np.int32), device=dev)
    a = torch.cat([raw, _field_rows(FQ, width, 4, dev)])[:width].contiguous()
    b = torch.cat([raw.flip(0), _field_rows(FQ, width, 5, dev).flip(0)])[:width].contiguous()
    got = _launched("mont_mul_mxu", lambda: MX.mont_mul_mxu(FQ, a, b))
    assert torch.equal(got, MX.mont_mul_mxu_plain(FQ, a, b))
    assert torch.equal(got, MK.mont_mul_plain(FQ, a, b))
    assert torch.equal(got, MK.mont_mul(FQ, a, b))
    bufs = torch.zeros((2, width * FQ.L + 1), dtype=torch.int32, device=dev)
    bufs[0, 1:], bufs[1, 1:] = a.reshape(-1), b.reshape(-1)
    au, bu = (bufs[i, 1:].view(width, FQ.L) for i in (0, 1))
    assert torch.equal(_launched("mont_mul_mxu", lambda: MX.mont_mul_mxu(FQ, au, bu)), got)


def _jubjub_rows(width, seed, dev):
    """(P, Q) (width, 48) rows of Jubjub points: O + O, P + P, P + (-P),
    O + P, P + O, the order-2 point twice, then distinct points of a chain;
    P with general Z (sums of encoded points), Q encoded (Z = 1)."""
    g = spending_key_generator()
    p = g * JubjubFr(random.Random(seed).randrange(1, 1 << 64))
    pts = []
    for _ in range(40):
        pts.append(p)
        p = p + g
    O, t = ExtendedPoint.identity(), ExtendedPoint.from_affine(Scalar(0), Scalar(SCALAR_MODULUS - 1))
    p1 = [O, pts[0], pts[1], O, pts[2], t] + pts[3:20]
    p2 = [O, pts[0], -pts[1], pts[3], O, t] + pts[20:37]
    reps = -(-width // len(p1))
    P, Q = (torch.as_tensor(np.concatenate(J.encode_points((x * reps)[:width]), axis=1).astype(np.int32),
                            device=dev) for x in (p1, p2))
    lam = _field_rows(FR, width + 5, seed, dev)[5:]  # non-zero: (X : Y : Z) = (lam X : lam Y : lam Z)
    P = torch.cat([MK.mont_mul_plain(FR, P[:, 16 * i : 16 * (i + 1)], lam) for i in range(3)], dim=1)
    return P, Q


def check_jubjub_add(dev, width):
    """The Edwards add on contiguous and strided rows (the MSM ladder's
    even and odd views) and on rows whose base and stride are not 16-byte
    aligned (the kernel's 4-byte staging), against its plain version and the
    host curve; at width 8 the lanes are every addition case (O + O, P + P,
    P + (-P), O + P, P + O, the order-2 point twice) and two generic pairs."""
    P, Q = _jubjub_rows(width, 50, dev)
    want = KJ.jubjub_add_plain(P, Q)
    pairs = torch.cat([P, Q], dim=1)
    Pu, Qu = (torch.cat([x[:, :1], x], dim=1)[:, 1:] for x in (P, Q))  # rows of 49 words, one word in
    assert torch.equal(_launched("jubjub_add", lambda: KJ.jubjub_add(P, Q)), want)
    assert torch.equal(_launched("jubjub_add", lambda: KJ.jubjub_add(pairs[:, :48], pairs[:, 48:])), want)
    assert torch.equal(_launched("jubjub_add", lambda: KJ.jubjub_add(Pu, Qu)), want)
    dec = [J.decode_points(*(r[:, 16 * i : 16 * (i + 1)] for i in range(3))) for r in (P, Q, want)]
    assert dec[2] == [a + b for a, b in zip(dec[0], dec[1])]


def check_fr_sqrt(dev, width):
    """The square root: roots and flags against the plain version; a root
    squares to its input exactly where the host's Euler criterion says one
    exists. The values of every 2-adic order come first (as many as the
    width holds: z^(2^k) c^2 for k = 1 .. 32, non-squares, 0, 1, -1), then
    seeded rows."""
    import chip_smoke

    edge = torch.as_tensor(F.encode(FR, chip_smoke._two_adic_values(seed=width)).astype(np.int32), device=dev)
    a = torch.cat([edge, _field_rows(FR, width, 6, dev)])[:width].contiguous()
    root, ok = _launched("fr_sqrt", lambda: KJ.fr_sqrt(a))
    want_root, want_ok = KJ.fr_sqrt_plain(a)
    assert torch.equal(root, want_root) and torch.equal(ok, want_ok)
    vals, roots = F.decode(FR, a), F.decode(FR, root)
    for v, r, k in zip(vals, roots, ok.tolist()):
        assert k == (v == 0 or pow(v, (FR.modulus - 1) // 2, FR.modulus) == 1)
        assert not k or r * r % FR.modulus == v


def check_pedersen_fold(dev, width):
    """The fold over the Merkle hash's 172 chunks, seeded digits, against
    its plain version."""
    table = PED._chunk_tables(172, dev)
    idx = torch.as_tensor(np.random.default_rng(60 + width).integers(0, 9, (172, width), dtype=np.int32), device=dev)
    assert torch.equal(_launched("pedersen_fold", lambda: KJ.pedersen_fold(table, idx)),
                       KJ.pedersen_fold_plain(table, idx))


class _Cubic:
    """x^3 + x + 5 == out, over the port's constraint systems."""

    def __init__(self, x=None):
        self.x = x

    def synthesize(self, cs):
        x = self.x
        xv = cs.alloc("x", x)
        x2 = cs.alloc("x2", None if x is None else x * x % FR.modulus)
        cs.enforce("x2", lc_var(xv), lc_var(xv), lc_var(x2))
        x3 = cs.alloc("x3", None if x is None else pow(x, 3, FR.modulus))
        cs.enforce("x3", lc_var(x2), lc_var(xv), lc_var(x3))
        out = cs.alloc_input("out", None if x is None else (pow(x, 3, FR.modulus) + x + 5) % FR.modulus)
        cs.enforce("out", lc_var(x3) + xv + (5, ONE), lc_var(ONE), lc_var(out))


def check_card_proof(dev):
    """A tiny proof on the card equals the port's CPU proof of the same
    witness and (r, s) byte for byte, and verifies (the CPU tests hold the
    CPU proof against the JAX package's host_proof)."""
    kcs = KeypairAssembly()
    _Cubic().synthesize(kcs)
    S.add_input_constraints(kcs)
    params = TG.generate_parameters(S.assembly_from_cs(kcs), 11, 13, 17, 19, 23, device="cpu")
    asm, _ = S.synthesize_witness(_Cubic(3), use_tape=False)
    c = TP.MSM_C
    TP.MSM_C = 4  # halves the CPU proof's bucket chains; the proof does not depend on it
    try:
        before = LAUNCHES["g1_add"]
        on_card = TG.create_proof_from_assembly(asm, params, 3, 4, device=dev)
        assert LAUNCHES["g1_add"] > before
        on_cpu = TG.create_proof_from_assembly(asm, params, 3, 4, device="cpu")
    finally:
        TP.MSM_C = c
    assert on_card.write() == on_cpu.write()
    assert verify_proof(prepare_verifying_key(params.vk), on_card, [35])


def check_mesh_proof(dev):
    """A tiny proof through create_proof_from_assembly(mesh=) on a virtual
    mesh of 2 positions of the card (c = 4) equals the port's CPU proof of
    the same witness and (r, s) byte for byte and verifies; every query
    shard lies on the card."""
    from masp_tpu_torch.parallel import mesh as PM

    kcs = KeypairAssembly()
    _Cubic().synthesize(kcs)
    S.add_input_constraints(kcs)
    params = TG.generate_parameters(S.assembly_from_cs(kcs), 11, 13, 17, 19, 23, device="cpu")
    asm, _ = S.synthesize_witness(_Cubic(3), use_tape=False)
    mesh = PM.make_mesh(2, devices=[dev] * 2)
    c = TP.MSM_C
    TP.MSM_C = 4
    try:
        before = LAUNCHES["g1_add"]
        on_mesh = TG.create_proof_from_assembly(asm, params, 3, 4, mesh=mesh)
        assert LAUNCHES["g1_add"] > before
        for q in ("h", "l", "a", "b_g1", "b_g2"):
            assert all(t.is_cuda for t in params.device[q].shards.values())
        on_cpu = TG.create_proof_from_assembly(asm, params, 3, 4, device="cpu")
    finally:
        TP.MSM_C = c
    assert on_mesh.write() == on_cpu.write()
    assert verify_proof(prepare_verifying_key(params.vk), on_mesh, [35])


def check_signed_digits(dev):
    """Signed digits on the card: windows_from_limbs(signed=True) and the
    signed sorted MSM (G1 and G2, c = 4 and 8, scan ladder) equal their CPU
    runs limb for limb, with 0, 1 and r - 1 among the scalars."""
    from masp_tpu_torch.ops import msm_sorted as MS

    rng = random.Random(11)
    scalars = [0, 1, SCALAR_MODULUS - 1] + [rng.randrange(SCALAR_MODULUS) for _ in range(13)]
    limbs = torch.as_tensor(F.encode(FR, scalars, mont=False).astype(np.int32))
    for group in (1, 2):
        grp, enc = GROUPS[group]
        pts = [grp.generator() * rng.randrange(1, 1 << 64) for _ in range(16)]
        rows = _proj_rows(group, pts, "cpu")
        fops = W.G1Ops if group == 1 else W.G2Ops
        for c in (4, 8):
            d_card = MS.windows_from_limbs(limbs.to(dev), c, signed=True)
            assert torch.equal(d_card.cpu(), MS.windows_from_limbs(limbs, c, signed=True)), (group, c)
            on_card = MS.sorted_msm_from_limbs(fops, rows.to(dev), limbs.to(dev), c, signed=True)
            on_cpu = MS.sorted_msm_from_limbs(fops, rows, limbs, c, signed=True)
            assert torch.equal(on_card.cpu(), on_cpu), (group, c)


class _Bits:
    """Six bits, their xor and and, packed into v; out = v^2 + (b0 xor b1):
    eight bit wires, so that the split runs when forced on."""

    def __init__(self, bits=None):
        self.bits = bits

    def synthesize(self, cs):
        from masp_tpu_torch.host.r1cs.gadgets.boolean import AllocatedBit

        vals = self.bits or [None] * 6
        bs = [AllocatedBit.alloc(cs, b) for b in vals]
        x = AllocatedBit.xor(cs, bs[0], bs[1])
        AllocatedBit.and_(cs, bs[2], bs[3])
        known = self.bits is not None
        v_val = sum(b << i for i, b in enumerate(vals)) if known else None
        v = cs.alloc("v", v_val)
        pack = lc_var(bs[0].var)
        for i, b in enumerate(bs[1:], 1):
            pack = pack + lc_var(b.var, 1 << i)
        cs.enforce("pack", pack, lc_var(ONE), lc_var(v))
        sq = cs.alloc("sq", v_val * v_val if known else None)
        cs.enforce("sq", lc_var(v), lc_var(v), lc_var(sq))
        out = cs.alloc_input("out", (v_val * v_val + (vals[0] ^ vals[1])) % FR.modulus if known else None)
        cs.enforce("out", lc_var(sq) + x.var, lc_var(ONE), lc_var(out))


ROUTES = {"host_digits": {"MASP_MSM_FROM_LIMBS": "0"}, "stacked": {"MASP_MSM_STACK": "1"},
          "fused": {"MASP_MSM_FUSED": "1"}, "bgmw_h": {"MASP_MSM_BGMW_H": "1"}, "lanes": {"MASP_MSM": "lanes"}}


def _with_flags(env: dict, fn):
    """fn() with the prover's MSM constants set as msm_flags derives them
    from ``env``; the constants are restored after."""
    saved = {k: getattr(TP, k) for k in TP.msm_flags({})}
    try:
        for k, v in TP.msm_flags(env).items():
            setattr(TP, k, v)
        return fn()
    finally:
        for k, v in saved.items():
            setattr(TP, k, v)


def check_routes(dev):
    """A tiny proof (six bits, the split forced on, c = 4) through each of
    the prover's five off-by-default routes on the card (BGMW at c = 5,
    lanes at 64 / 32) equals the port's default CPU proof of the same
    witness and (r, s) and verifies, and so does a proof on a 2-position
    virtual mesh of the card with host digits, and with the routes a mesh
    ignores (stacked, fused, BGMW); the BGMW table (c = 5, 16 points with
    an identity) and sorted_msm_batch (Q = 4, N = 16, c = 4) on the card
    equal their CPU runs limb for limb."""
    from masp_tpu_torch.ops import msm_sorted as MS

    kcs = KeypairAssembly()
    _Bits().synthesize(kcs)
    S.add_input_constraints(kcs)
    params = TG.generate_parameters(S.assembly_from_cs(kcs), 11, 13, 17, 19, 23, device="cpu")
    bits = [1, 0, 1, 1, 0, 1]
    asm, _ = S.synthesize_witness(_Bits(bits), use_tape=False)
    base = {"MASP_MSM_C": "4", "MASP_MSM_SPLIT_MIN": "2", "MASP_MSM_BGMW_C": "5"}
    on_cpu = _with_flags(base, lambda: TG.create_proof_from_assembly(asm, params, 3, 4, device="cpu")).write()
    pvk = prepare_verifying_key(params.vk)
    v = sum(b << i for i, b in enumerate(bits))
    for route, env in ROUTES.items():
        before = LAUNCHES["g1_add"]
        proof = _with_flags({**base, **env}, lambda: TG.create_proof_from_assembly(asm, params, 3, 4, device=dev))
        assert LAUNCHES["g1_add"] > before, route
        assert params.device["dev"].type == "cuda", route
        assert proof.write() == on_cpu, route
        assert verify_proof(pvk, proof, [v * v + (bits[0] ^ bits[1])]), route
    # a mesh takes host digits where they are on, and ignores the stacked,
    # fused and BGMW routes
    from masp_tpu_torch.parallel import mesh as PM

    mesh = PM.make_mesh(2, devices=[dev] * 2)
    for env in ({"MASP_MSM_FROM_LIMBS": "0"}, {"MASP_MSM_STACK": "1"},
                {"MASP_MSM_FUSED": "1", "MASP_MSM_BGMW_H": "1"}):
        proof = _with_flags({**base, **env}, lambda: TG.create_proof_from_assembly(asm, params, 3, 4, mesh=mesh))
        assert proof.write() == on_cpu, env
        assert params.device["layout"] == "sorted" and "h_bgmw" not in params.device, env

    rng = random.Random(5)
    pts = [G1.generator() * rng.randrange(1, 1 << 64) for _ in range(15)] + [G1.identity()]
    rows = _proj_rows(1, pts, "cpu")
    table = MS.build_bgmw_table(W.G1Ops, rows, 5)
    assert torch.equal(_launched("g1_add", lambda: MS.build_bgmw_table(W.G1Ops, rows.to(dev), 5),
                                 times=5 * (MS.n_windows_for(5) - 1)).cpu(), table)
    limbs = torch.as_tensor(F.encode(FR, [rng.randrange(SCALAR_MODULUS) for _ in range(16)], mont=False)
                            .astype(np.int32))
    on_card = MS.bgmw_msm_from_limbs(W.G1Ops, table.to(dev), limbs.to(dev), 5)
    assert torch.equal(on_card.cpu(), MS.bgmw_msm_from_limbs(W.G1Ops, table, limbs, 5))
    qrows = torch.stack([_proj_rows(1, [G1.generator() * rng.randrange(1, 1 << 64) for _ in range(16)], "cpu")
                         for _ in range(4)])
    digits = torch.stack([MS.windows_from_limbs(torch.as_tensor(
        F.encode(FR, [rng.randrange(SCALAR_MODULUS) for _ in range(16)], mont=False).astype(np.int32)), 4)
        for _ in range(4)])
    on_card = MS.sorted_msm_batch(W.G1Ops, qrows.to(dev), digits.to(dev), 4)
    assert torch.equal(on_card.cpu(), MS.sorted_msm_batch(W.G1Ops, qrows, digits, 4))


def check_note_scan(dev):
    """The port's AEAD (host/crypto.py, since the card machine need not have
    `cryptography`) against RFC 8439 §2.8.2, and SaplingDomain.batch_epk's
    device branch at 64 encodings, its default threshold, with two invalid
    ones, against the host route."""
    text = (b"Ladies and Gentlemen of the class of '99: If I could offer you only one tip for the future, "
            b"sunscreen would be it.")
    nonce, aad = bytes.fromhex("070000004041424344454647"), bytes.fromhex("50515253c0c1c2c3c4c5c6c7")
    sealed = ChaCha20Poly1305(bytes(range(0x80, 0xA0))).encrypt(nonce, text, aad)
    assert sealed.hex() == (
        "d31a8d34648e60db7b86afbc53ef7ec2a4aded51296e08fea9e2b5a736ee62d63dbea45e8ca9671282fafb69da92728b"
        "1a71de0a9e060b2905d6a5b67ecd3b3692ddbd7f2d778b8c9803aee328091b58fab324e4fad675945585808b4831d7bc"
        "3ff4def08e4b7a9de576d26586cec64b6116" "1ae10b594f09e26a7e902ecbd0600691")
    assert ChaCha20Poly1305(bytes(range(0x80, 0xA0))).decrypt(nonce, sealed, aad) == text
    g = spending_key_generator()
    encodings = [(g * JubjubFr(7 * i + 2)).to_bytes() for i in range(62)]
    encodings += [(SCALAR_MODULUS + 1).to_bytes(32, "little"), b"\x00" * 31]
    domain = SaplingDomain(TEST_NETWORK, 10)
    on_card = _launched("fr_sqrt", lambda: domain.batch_epk(encodings))
    assert on_card == domain.batch_epk(encodings, use_device=False)
    assert [p is None for p, _ in on_card] == [False] * 62 + [True, True]


CASES = (
    [(check_mont_mul, (name, w, form)) for name in SPECS for w in WIDTHS for form in mont_mul_forms(w)]
    + [(check_mont_inv, (name, w)) for name in SPECS for w in INV_WIDTHS]
    + [(check_point_add, (g, leaf, w)) for g in (1, 2) for leaf in (False, True) for w in ADD_WIDTHS]
    + [(check_point_add, (g, leaf, 128, True)) for g in (1, 2) for leaf in (False, True)]
    + [(check_affine_pre_post, (g, w)) for g in (1, 2) for w in WIDTHS]
    + [(check_int8_dot, (w,)) for w in WIDTHS]
    + [(check_mont_mul_mxu, (w,)) for w in WIDTHS]
    + [(check_jubjub_add, (w,)) for w in sorted(ADD_WIDTHS + [8])]
    + [(check_fr_sqrt, (w,)) for w in WIDTHS]
    + [(check_pedersen_fold, (w,)) for w in WIDTHS + [64, 4096]]
    + [(check_card_proof, ()), (check_note_scan, ()), (check_mesh_proof, ()), (check_signed_digits, ()),
       (check_routes, ())]
)


@pytest.mark.cuda
def test_kernels_match_plain(dev):
    """Every case above; the failures are listed together."""
    failed = []
    for check, args in CASES:
        try:
            check(dev, *args)
        except AssertionError as e:
            failed.append(f"{check.__name__}{args}: {e}")
    assert not failed, "\n".join(failed)
