"""Pure-host reference Groth16 prover (Python integers, host curve ops).

A rewrite of masp_tpu/groth16/reference.py over the port's ``Assembly`` and
``Parameters``: an oracle independent of the device prover, with the same
math as ``create_proof_from_assembly`` (bellman's create_proof) in Python
integers and the host curve. O(m log m) NTTs and O(n) scalar
multiplications: for test shapes only, where the sharded tools and the
multi-process demo hold the mesh prover against it.
"""

from __future__ import annotations

import torch

from masp_tpu_torch.groth16.domain import Domain
from masp_tpu_torch.groth16.generator import coeff_ints, densities
from masp_tpu_torch.host.bls12_381 import R
from masp_tpu_torch.host.structures import Proof
from masp_tpu_torch.ops import weierstrass as W
from masp_tpu_torch.ops.projective import unpack_rows


def _fft(vals: list[int], om: int) -> list[int]:
    m = len(vals)
    if m == 1:
        return list(vals)
    om2 = om * om % R
    even = _fft(vals[0::2], om2)
    odd = _fft(vals[1::2], om2)
    out = [0] * m
    w = 1
    for i in range(m // 2):
        t = w * odd[i] % R
        out[i] = (even[i] + t) % R
        out[i + m // 2] = (even[i] - t) % R
        w = w * om % R
    return out


def host_h_from_vals(a_vals, b_vals, c_vals, m: int) -> list[int]:
    """h(x) coefficients from per-constraint evaluation lists (canonical
    ints, zero-padded to m here)."""
    dom = Domain(m, device="cpu")

    def coset_eval(vals):
        vals = list(vals) + [0] * (m - len(vals))
        coeffs = [v * dom.m_inv % R for v in _fft(vals, dom.omega_inv)]
        coeffs = [v * pow(dom.g, i, R) % R for i, v in enumerate(coeffs)]
        return _fft(coeffs, dom.omega)

    a, b, c = coset_eval(a_vals), coset_eval(b_vals), coset_eval(c_vals)
    t = [(x * y - z) * dom.z_on_coset_inv % R for x, y, z in zip(a, b, c)]
    h = [v * dom.m_inv % R for v in _fft(t, dom.omega_inv)]
    return [v * pow(dom.g_inv, i, R) % R for i, v in enumerate(h)]


def _values(asm) -> list[int]:
    return [int.from_bytes(row.tobytes(), "little") for row in asm.assignment]


def host_abc(asm) -> tuple[list[int], list[int], list[int]]:
    """The per-constraint A, B and C evaluations of the witness."""
    vals = _values(asm)
    coeffs = coeff_ints(asm.coeffs)
    var_idx = asm.var_idx.tolist()
    ip = asm.indptr.tolist()
    rows = [sum(coeffs[e] * vals[var_idx[e]] for e in range(ip[j], ip[j + 1])) % R
            for j in range(len(ip) - 1)]
    n = asm.num_constraints
    return rows[:n], rows[n : 2 * n], rows[2 * n :]


def _host_msm(points, scalars):
    acc = type(points[0]).identity()
    for p, s in zip(points, scalars):
        if s:
            acc = acc + p * s
    return acc


def _points(rows, group: int):
    dec = W.decode_g1_points if group == 1 else W.decode_g2_points
    return dec(*unpack_rows(group, torch.as_tensor(rows)))


def host_proof(asm, params, r: int, s: int) -> Proof:
    """The proof create_proof_from_assembly must give, computed on the host."""
    m = 1 << (asm.num_constraints - 1).bit_length()
    h = host_h_from_vals(*host_abc(asm), m)[: m - 1]
    full = _values(asm)
    a_density, b_density = densities(asm)
    a_exps = [v for v, d in zip(full, a_density) if d]
    b_exps = [v for v, d in zip(full, b_density) if d]
    h_ans = _host_msm(_points(params.h, 1), h)
    l_ans = _host_msm(_points(params.l, 1), full[asm.num_inputs :])
    a_ans = _host_msm(_points(params.a, 1), a_exps)
    b1_ans = _host_msm(_points(params.b_g1, 1), b_exps)
    b2_ans = _host_msm(_points(params.b_g2, 2), b_exps)
    vk = params.vk
    g_a = vk.delta_g1 * r + vk.alpha_g1 + a_ans
    g_b = vk.delta_g2 * s + vk.beta_g2 + b2_ans
    g_c = vk.delta_g1 * (r * s % R) + vk.alpha_g1 * s + vk.beta_g1 * r
    g_c = g_c + h_ans + l_ans + a_ans * s + b1_ans * r
    return Proof(a=g_a, b=g_b, c=g_c)


__all__ = ["host_proof", "host_abc", "host_h_from_vals"]
