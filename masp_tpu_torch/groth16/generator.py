"""Groth16 parameter generation from known toxic waste (bellman
``generate_parameters`` semantics).

Port of masp_tpu/groth16/generator.py for the port's neutral ``Assembly``:
the QAP polynomials are evaluated at tau on the host (Lagrange basis over
the domain), and the per-query fixed-base scalar multiplications run on the
device through the point-add kernel (ops/msm.fixed_base_scalarmuls) in
chunks of at most 2^16 G1 or 2^14 G2 scalars, then one batched inversion
per chunk makes them affine. ``generate_random_parameters`` draws the toxic
waste and synthesises the structure of a circuit of the host copies.
"""

from __future__ import annotations

import numpy as np
import torch

from masp_tpu_torch import resolve_device
from masp_tpu_torch.groth16.domain import Domain
from masp_tpu_torch.groth16.params import Assembly, Parameters
from masp_tpu_torch.groth16.synthesis import add_input_constraints, assembly_from_cs
from masp_tpu_torch.host.bls12_381 import G1, G2, R
from masp_tpu_torch.host.r1cs.cs import KeypairAssembly
from masp_tpu_torch.host.rng import random_scalar
from masp_tpu_torch.host.structures import VerifyingKey
from masp_tpu_torch.ops import msm as M
from masp_tpu_torch.ops import weierstrass as W
from masp_tpu_torch.ops.projective import unpack_rows


def coeff_ints(coeffs: np.ndarray) -> list[int]:
    """(nnz, 4) uint64 little-endian coefficients -> Python ints (the
    distinct values are few: decode each once)."""
    if coeffs.shape[0] == 0:
        return []
    uniq, inv = np.unique(coeffs, axis=0, return_inverse=True)
    vals = [int.from_bytes(u.tobytes(), "little") for u in np.ascontiguousarray(uniq)]
    return [vals[i] for i in inv.reshape(-1)]


def densities(asm: Assembly):
    """Per-variable (inputs then aux) appearance masks in A and B."""
    n = asm.num_constraints
    a_density = np.zeros(asm.num_vars, dtype=bool)
    b_density = np.zeros(asm.num_vars, dtype=bool)
    a_density[asm.var_idx[asm.indptr[0] : asm.indptr[n]]] = True
    b_density[asm.var_idx[asm.indptr[n] : asm.indptr[2 * n]]] = True
    return a_density, b_density


def eval_at_tau(asm: Assembly, tau: int, m: int):
    """u_i(tau), v_i(tau), w_i(tau) per variable via Lagrange evaluation."""
    omega = Domain(m, device="cpu").omega
    n = asm.num_constraints
    # L_j(tau) = (tau^m - 1) * omega^j / (m * (tau - omega^j))
    zt = (pow(tau, m, R) - 1) % R
    omega_pows = [1] * n
    for j in range(1, n):
        omega_pows[j] = omega_pows[j - 1] * omega % R
    denoms = [(m * (tau - op)) % R for op in omega_pows]
    prefix = [1] * (n + 1)
    for i, d in enumerate(denoms):
        prefix[i + 1] = prefix[i] * d % R
    inv_all = pow(prefix[-1], -1, R)
    invs = [0] * n
    for i in range(n - 1, -1, -1):
        invs[i] = inv_all * prefix[i] % R
        inv_all = inv_all * denoms[i] % R
    lag = [zt * op % R * inv % R for op, inv in zip(omega_pows, invs)]

    coeffs = coeff_ints(asm.coeffs)
    var_idx = asm.var_idx.tolist()
    indptr = asm.indptr.tolist()
    out = []
    for k in range(3):
        acc = [0] * asm.num_vars
        for j in range(n):
            lj = lag[j]
            for e in range(indptr[k * n + j], indptr[k * n + j + 1]):
                acc[var_idx[e]] += coeffs[e] * lj
        out.append([x % R for x in acc])
    return out[0], out[1], out[2]


def _affine_rows(fops, proj):
    """Projective rows -> affine-encoded rows (Z = mont-1, identity (0,1,0))."""
    X, Y, Z = unpack_rows(fops.GROUP, proj)
    x, y = W.to_affine(fops, (X, Y, Z))
    ident = fops.is_zero(Z)
    one = fops.one_like(x)
    zero = torch.zeros_like(x)
    sel = ident.reshape(ident.shape + (1,) * len(fops.coord_shape))
    n = proj.shape[0]
    coords = (torch.where(sel, zero, x), torch.where(sel, one, y), torch.where(sel, zero, one))
    return torch.cat([c.reshape(n, -1) for c in coords], dim=1)


# scalars a chunk of batch_mul_gen, per group: the chunks of the JAX package's
# batch_g1_mul_gen and batch_g2_mul_gen. Its _chunk_pad, which pads a chunk to
# a power of two so that XLA compiles few programs, has no use here: PyTorch
# compiles nothing, and the padding only adds work
CHUNK = {1: 1 << 16, 2: 1 << 14}


def batch_mul_gen(fops, table_rows, scalars: list[int]) -> np.ndarray:
    """[s_i] G for the table's base G, as affine-encoded packed rows (numpy),
    CHUNK[group] scalars at a time."""
    dev = table_rows.device
    out = [np.zeros((0, W.rowlen(fops)), dtype=np.int32)]
    for off in range(0, len(scalars), CHUNK[fops.GROUP]):
        part = scalars[off : off + CHUNK[fops.GROUP]]
        digits = torch.as_tensor(M.scalars_to_digits(part, 8, 256), device=dev).to(torch.int64)
        proj = M.fixed_base_scalarmuls(fops, table_rows, digits)
        out.append(_affine_rows(fops, proj).cpu().numpy())
    return np.concatenate(out)


def generate_parameters(asm: Assembly, tau: int, alpha: int, beta: int, gamma: int,
                        delta: int, device="cuda") -> Parameters:
    """Parameters of the circuit whose structure ``asm`` holds (input
    constraints included), for the given toxic waste."""
    dev = resolve_device(device)
    m = 1 << (asm.num_constraints - 1).bit_length()
    u, v, w = eval_at_tau(asm, tau, m)
    a_density, b_density = densities(asm)
    n_inputs = asm.num_inputs

    gamma_inv = pow(gamma, -1, R)
    delta_inv = pow(delta, -1, R)
    ic_scalars = [(beta * u[i] + alpha * v[i] + w[i]) % R * gamma_inv % R for i in range(n_inputs)]
    l_scalars = [
        (beta * u[i] + alpha * v[i] + w[i]) % R * delta_inv % R for i in range(n_inputs, len(u))
    ]
    a_scalars = [u[i] for i in range(len(u)) if a_density[i]]
    b_scalars = [v[i] for i in range(len(v)) if b_density[i]]
    # h query: tau^i * Z(tau) / delta for i in 0..m-2
    zd = (pow(tau, m, R) - 1) % R * delta_inv % R
    h_scalars = [0] * (m - 1)
    cur = zd
    for i in range(m - 1):
        h_scalars[i] = cur
        cur = cur * tau % R

    g1, g2 = G1.generator(), G2.generator()
    t1 = M.encode_table(W.G1Ops, M.fixed_base_table(g1, c=8, num_bits=256), dev)
    t2 = M.encode_table(W.G2Ops, M.fixed_base_table(g2, c=8, num_bits=256), dev)
    ic_rows = batch_mul_gen(W.G1Ops, t1, ic_scalars)
    ic = W.decode_g1_points(*unpack_rows(1, torch.as_tensor(ic_rows)))
    vk = VerifyingKey(
        alpha_g1=g1 * alpha, beta_g1=g1 * beta, beta_g2=g2 * beta,
        gamma_g2=g2 * gamma, delta_g1=g1 * delta, delta_g2=g2 * delta, ic=ic,
    )
    return Parameters(
        vk=vk,
        h=batch_mul_gen(W.G1Ops, t1, h_scalars),
        l=batch_mul_gen(W.G1Ops, t1, l_scalars),
        a=batch_mul_gen(W.G1Ops, t1, a_scalars),
        b_g1=batch_mul_gen(W.G1Ops, t1, b_scalars),
        b_g2=batch_mul_gen(W.G2Ops, t2, b_scalars),
    )


def generate_random_parameters(circuit, rng, device="cuda") -> Parameters:
    """Parameters of ``circuit`` (a circuit of the host copies) for toxic
    waste drawn from ``rng``: five non-zero scalars, tau, alpha, beta, gamma
    and delta in that order, as the JAX package draws them."""
    def nonzero():
        while True:
            x = random_scalar(rng)
            if not x.is_zero():
                return x.n

    waste = [nonzero() for _ in range(5)]
    cs = KeypairAssembly()
    circuit.synthesize(cs)
    add_input_constraints(cs)
    return generate_parameters(assembly_from_cs(cs), *waste, device=device)


__all__ = [
    "generate_parameters", "generate_random_parameters", "eval_at_tau", "densities",
    "coeff_ints", "batch_mul_gen",
]
