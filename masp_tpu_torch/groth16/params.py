"""The port's proving parameters and R1CS assembly, and their constructors
from the JAX package's arrays.

Both are neutral containers of numpy arrays, so state crosses from the JAX
package without the port seeing any of its objects:

* ``Parameters``: the verifying key as (the port's) host points, and each
  proving query as packed [X | Y | Z] limb rows (n, 72) on G1 and (n, 144)
  on G2, int32 16-bit Montgomery limbs, identity as (0, 1, 0). Device copies
  are cached in ``device`` by the prover. ``params_from_host`` /
  ``params_to_host`` carry them to and from the host ``Parameters`` of
  ``host/structures.py``, which read and write bellman's file format.
* ``Assembly``: the R1CS of one proof: the CSR of the A | B | C rows
  (indptr over 3 n rows, variable indices into inputs ++ aux, (nnz, 4)
  uint64 little-endian coefficients) and the (n_vars, 4) uint64 assignment,
  None for a structure-only assembly (parameter generation).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from masp_tpu_torch.host import structures as HS
from masp_tpu_torch.host.structures import VerifyingKey
from masp_tpu_torch.ops import weierstrass as W
from masp_tpu_torch.ops.projective import unpack_rows

@dataclass
class Parameters:
    vk: VerifyingKey
    h: np.ndarray
    l: np.ndarray
    a: np.ndarray
    b_g1: np.ndarray
    b_g2: np.ndarray
    device: dict = field(default_factory=dict, compare=False, repr=False)

    def rows(self, name: str) -> np.ndarray:
        return getattr(self, name)


@dataclass
class Assembly:
    num_inputs: int
    num_vars: int
    num_constraints: int
    indptr: np.ndarray
    var_idx: np.ndarray
    coeffs: np.ndarray
    assignment: np.ndarray | None = None


def _pack(coords) -> np.ndarray:
    n = np.asarray(coords[0]).shape[0]
    return np.concatenate(
        [np.asarray(c).reshape(n, -1) for c in coords], axis=1
    ).astype(np.int32)


def params_from_arrays(vk_g1, vk_g2, ic, h, l, a, b_g1, b_g2) -> Parameters:
    """The port's Parameters from limb arrays as the JAX package's
    ``encode_g1_points`` / ``encode_g2_points`` give them: each argument is an
    (X, Y, Z) triple. vk_g1 encodes [alpha_g1, beta_g1, delta_g1], vk_g2
    [beta_g2, gamma_g2, delta_g2], ic the IC points; h .. b_g2 the queries."""
    alpha_g1, beta_g1, delta_g1 = W.decode_g1_points(*vk_g1)
    beta_g2, gamma_g2, delta_g2 = W.decode_g2_points(*vk_g2)
    vk = VerifyingKey(
        alpha_g1=alpha_g1, beta_g1=beta_g1, beta_g2=beta_g2, gamma_g2=gamma_g2,
        delta_g1=delta_g1, delta_g2=delta_g2, ic=W.decode_g1_points(*ic),
    )
    return Parameters(vk=vk, h=_pack(h), l=_pack(l), a=_pack(a),
                      b_g1=_pack(b_g1), b_g2=_pack(b_g2))


def params_from_host(p: HS.Parameters) -> Parameters:
    """The port's Parameters of host Parameters, as ``HS.Parameters.read``
    gives them from a bellman-format file."""
    enc1, enc2 = W.encode_g1_points, W.encode_g2_points
    return Parameters(vk=p.vk, h=_pack(enc1(p.h)), l=_pack(enc1(p.l)), a=_pack(enc1(p.a)),
                      b_g1=_pack(enc1(p.b_g1)), b_g2=_pack(enc2(p.b_g2)))


def params_to_host(p: Parameters) -> HS.Parameters:
    """Host Parameters of the port's, so that ``write`` gives the bellman
    format; the inverse of ``params_from_host``."""
    def dec(rows, group):
        decode = W.decode_g1_points if group == 1 else W.decode_g2_points
        return decode(*unpack_rows(group, torch.as_tensor(rows)))

    return HS.Parameters(vk=p.vk, h=dec(p.h, 1), l=dec(p.l, 1), a=dec(p.a, 1),
                         b_g1=dec(p.b_g1, 1), b_g2=dec(p.b_g2, 2))


def assembly_from_arrays(num_inputs: int, indptr, var_idx, coeffs, assignment=None,
                         num_vars: int | None = None) -> Assembly:
    """The port's Assembly from the arrays the JAX package's ``_csr_for``
    and ``_assignment_u64`` give. ``num_vars`` (inputs + aux) is needed only
    without an assignment."""
    indptr = np.asarray(indptr, dtype=np.int64)
    if (indptr.shape[0] - 1) % 3:
        raise ValueError("indptr must cover the A, B and C rows")
    coeffs = np.ascontiguousarray(coeffs, dtype=np.uint64)
    var_idx = np.asarray(var_idx, dtype=np.int64)
    if coeffs.shape != (var_idx.shape[0], 4) or indptr[-1] != var_idx.shape[0]:
        raise ValueError("CSR arrays disagree in length")
    if assignment is not None:
        assignment = np.ascontiguousarray(assignment, dtype=np.uint64)
        if assignment.ndim != 2 or assignment.shape[1] != 4:
            raise ValueError("assignment must be (n_vars, 4) uint64")
        num_vars = assignment.shape[0]
    if num_vars is None:
        raise ValueError("num_vars is needed without an assignment")
    if var_idx.size and (var_idx.min() < 0 or var_idx.max() >= num_vars):
        raise ValueError("CSR variable index out of range")
    return Assembly(
        num_inputs=int(num_inputs), num_vars=int(num_vars),
        num_constraints=(indptr.shape[0] - 1) // 3,
        indptr=indptr, var_idx=var_idx, coeffs=coeffs, assignment=assignment,
    )


__all__ = [
    "Parameters", "Assembly", "params_from_arrays", "params_from_host", "params_to_host",
    "assembly_from_arrays",
]
