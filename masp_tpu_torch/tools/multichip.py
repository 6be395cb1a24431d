"""Entry points of the multi-device check, the port's twin of the JAX
package's __graft_entry__.py.

``entry()`` gives the Groth16 proving core (the NTT quotient pipeline and a
lane-private Pippenger MSM over G1) at reduced shapes, as a function and its
arguments. ``dryrun_multichip(n)`` builds an n-position mesh, dp (the proof
batch) x msm (the points of one MSM), runs ``dp_batch_ntt``,
``sharded_pippenger`` and ``sharded_ntt`` on it at tiny shapes and holds each
against the single-device result; then ``mesh_prover_check(n)`` proves a
squaring chain through ``create_proof_from_assembly(mesh=)`` over all n
positions and holds the proof against the host prover
(groth16/reference.py).

The devices come from the caller; by default every position is the first
card (a virtual mesh on one card). ``devices=["cpu"] * n`` runs the same on
the CPU through the kernels' plain versions.

    python -m masp_tpu_torch.tools.multichip            # entry, then the dry run on 8 positions of the card
    python -m masp_tpu_torch.tools.multichip --cpu 4    # the same on 4 CPU positions
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from masp_tpu_torch.groth16 import prover as TP
from masp_tpu_torch.groth16 import synthesis as S
from masp_tpu_torch.groth16.domain import Domain
from masp_tpu_torch.groth16.generator import densities
from masp_tpu_torch.groth16.params import Parameters, _pack
from masp_tpu_torch.groth16.reference import host_proof
from masp_tpu_torch.host.bls12_381 import G1, G2, R
from masp_tpu_torch.host.r1cs.cs import ONE, lc_var
from masp_tpu_torch.host.structures import VerifyingKey
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops import msm as M
from masp_tpu_torch.ops import weierstrass as W
from masp_tpu_torch.ops.field import FR
from masp_tpu_torch.parallel import mesh as PM


def _devices(n: int, devices) -> list:
    return [torch.device("cuda")] * n if devices is None else [torch.device(d) for d in devices]


def entry(device="cuda"):
    """(fn, args): the Groth16 prove core at m = 256 and 256 points, c = 8,
    8 lanes: h from a/b/c (iNTT, coset NTT, a b - c, divide by Z, inverse
    coset NTT), its byte digits on the device, then ``pippenger_msm``."""
    m, n_points, lanes, c = 256, 256, 8, 8
    dom = Domain(m, device=device)

    def prove_core(az, bz, cz, px, py, pz):
        a, b, cc = (dom.coset_fft(dom.ifft(v)) for v in (az, bz, cz))
        t = F.sub(FR, F.mont_mul(FR, a, b), cc)
        h = dom.icoset_fft(dom.divide_by_z_on_coset(t))
        digits = torch.zeros(n_points, 32, dtype=torch.int64, device=az.device)
        digits[: m - 1] = M.fr_digits_device(h[: m - 1])
        return M.pippenger_msm(W.G1Ops, (px, py, pz), digits, c, lanes=lanes)

    rng = np.random.default_rng(0)
    abc = [torch.as_tensor(F.encode(FR, [int(v) for v in rng.integers(1, 1 << 62, m)]).astype(np.int32),
                           device=device) for _ in range(3)]
    pts = [G1.generator() * int(k) for k in rng.integers(1, 1 << 30, 8)] * (n_points // 8)
    xyz = tuple(torch.as_tensor(x.astype(np.int32), device=device) for x in W.encode_g1_points(pts))
    return prove_core, (*abc, *xyz)


def _g1(rows) -> G1:
    return W.decode_g1_points(*(torch.as_tensor(x).cpu()[None] for x in rows))[0]


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """dp = 2 by msm = n/2 positions: dp_batch_ntt over 4 proofs' values,
    sharded_pippenger (c = 4, 4 lanes) and sharded_ntt (m = 64) over msm,
    each held against its single-device result; then mesh_prover_check."""
    if n_devices < 2 or n_devices % 2:
        raise ValueError("need an even device count")
    devs = _devices(n_devices, devices)
    dp, msm = 2, n_devices // 2
    mesh = PM.Mesh(np.asarray(devs, dtype=object).reshape(dp, msm), ("dp", "msm"))
    home = devs[0]
    m, lanes, c = 64, 4, 4
    n_points = msm * 8 * 16
    batch = dp * 2
    dom = Domain(m, device=home)
    rng = np.random.default_rng(1)
    vals = torch.as_tensor(np.stack([F.encode(FR, [int(v) for v in rng.integers(1, 1 << 62, m)])
                                     for _ in range(batch)]).astype(np.int32))
    pts = [G1.generator() * int(k) for k in rng.integers(1, 1 << 30, 8)] * (n_points // 8)
    xyz = tuple(torch.as_tensor(x.astype(np.int32)) for x in W.encode_g1_points(pts))
    digits = torch.as_tensor(M.scalars_to_digits([int(k) for k in rng.integers(1, 1 << 30, n_points)], c, 16))
    poly = torch.as_tensor(F.encode(FR, [int(v) for v in rng.integers(1, 1 << 62, m)]).astype(np.int32))

    ntt_out = PM.dp_batch_ntt(mesh, dom, vals, axis="dp")
    point = PM.sharded_pippenger(mesh, W.G1Ops, xyz, digits, c, lanes, axis="msm")
    sp_ntt = PM.sharded_ntt(mesh, dom, poly, axis="msm")

    for p in mesh.local_positions():
        for t in (ntt_out.shards[p], point.shards[p], sp_ntt.shards[p]):
            if t.device != mesh.device(p):
                raise AssertionError(f"position {p}: a shard on {t.device}, not {mesh.device(p)}")
    if F.decode(FR, PM.gather(ntt_out)) != F.decode(FR, dom.fft(vals.to(home)).reshape(-1, FR.L)):
        raise AssertionError("dp_batch_ntt disagrees with the single-device NTT")
    if F.decode(FR, PM.gather(sp_ntt)) != F.decode(FR, dom.fft(poly.to(home))):
        raise AssertionError("sharded NTT disagrees with the single-device NTT")
    local = M.pippenger_msm(W.G1Ops, tuple(x.to(home) for x in xyz), digits.to(home), c, lanes=lanes)
    got = PM.gather(point)
    k = got.shape[0] // 3
    if _g1(tuple(got[i * k : (i + 1) * k] for i in range(3))) != _g1(local):
        raise AssertionError("sharded MSM disagrees with the single-device MSM")
    print(f"dryrun_multichip({n_devices}): mesh dp={dp} x msm={msm} on {sorted({str(d) for d in devs})} OK; "
          f"ntt {tuple(ntt_out.shape)}, msm point verified, sharded ntt verified", flush=True)
    mesh_prover_check(n_devices, devs)


class Chain:
    """Squarings x_{i+1} = x_i^2 from x0, the last one public: ``k``
    squarings give k + 1 constraints with the input constraint (12: m = 16,
    the dry run's; 60: m = 64)."""

    def __init__(self, x0=None, k: int = 12):
        self.x0, self.k = x0, k

    def synthesize(self, cs):
        v = cs.alloc("x0", self.x0)
        cur = self.x0
        for i in range(self.k):
            nxt = None if cur is None else cur * cur % R
            nv = cs.alloc(f"x{i + 1}", nxt)
            cs.enforce(f"sq{i}", lc_var(v), lc_var(v), lc_var(nv))
            v, cur = nv, nxt
        out = cs.alloc_input("out", cur)
        cs.enforce("out", lc_var(v), lc_var(ONE), lc_var(out))


def random_params(asm, seed: int) -> Parameters:
    """Parameters of the right sizes for ``asm`` from seeded random points
    (no toxic waste: the proofs they give hold against the host prover, not
    a verifier)."""
    m = 1 << (asm.num_constraints - 1).bit_length()
    ad, bd = densities(asm)
    rng = np.random.default_rng(seed)

    def g1():
        return G1.generator() * int(rng.integers(1, 1 << 40))

    def g2():
        return G2.generator() * int(rng.integers(1, 1 << 40))

    vk = VerifyingKey(alpha_g1=g1(), beta_g1=g1(), beta_g2=g2(), gamma_g2=g2(), delta_g1=g1(), delta_g2=g2(),
                      ic=[g1() for _ in range(asm.num_inputs)])
    enc1, enc2 = W.encode_g1_points, W.encode_g2_points
    return Parameters(vk=vk, h=_pack(enc1([g1() for _ in range(m - 1)])),
                      l=_pack(enc1([g1() for _ in range(asm.num_vars - asm.num_inputs)])),
                      a=_pack(enc1([g1() for _ in range(int(ad.sum()))])),
                      b_g1=_pack(enc1([g1() for _ in range(int(bd.sum()))])),
                      b_g2=_pack(enc2([g2() for _ in range(int(bd.sum()))])))


def mesh_prover_check(n_devices: int, devices=None) -> None:
    """create_proof_from_assembly(mesh=) of a 12-squaring chain (m = 16) at
    c = 4 over all n positions, against the host prover (groth16/
    reference.py)."""
    devs = _devices(n_devices, devices)
    mesh = PM.make_mesh(n_devices, devices=devs)
    asm, _ = S.synthesize_witness(Chain(12345), use_tape=False)
    params = random_params(asm, 9)
    c, TP.MSM_C = TP.MSM_C, 4  # 16 buckets: a short reduction on the CPU; the proof does not depend on c
    try:
        proof = TP.create_proof_from_assembly(asm, params, 11, 22, mesh=mesh)
    finally:
        TP.MSM_C = c
    if proof != host_proof(asm, params, 11, 22):
        raise AssertionError("the mesh prover disagrees with the host prover")
    m = 1 << (asm.num_constraints - 1).bit_length()
    print(f"mesh prover check OK: m={m}, {n_devices}-way msm sharding, proof == host reference", flush=True)


def main(argv) -> int:
    if "--cpu" in argv:
        n = int(argv[argv.index("--cpu") + 1])
        devices, home = ["cpu"] * n, "cpu"
    else:
        n, devices, home = 8, None, "cuda"
    fn, args = entry(home)
    fn(*args)
    print("entry() ran", flush=True)
    dryrun_multichip(n, devices)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
