"""From a circuit of the port's host copies (``host/circuits``) to the port's
``Assembly``: the structure for parameter generation and the witness of one
proof.

Counterpart of the JAX package's ``_add_input_constraints``
(masp_tpu/groth16/generator.py), ``_csr_for`` / ``_assignment_u64`` and
``synthesize_witness`` (masp_tpu/groth16/prover.py). The r1cs copies number
variables interleaved (input i is 2 i, aux j is 2 j + 1); the ``Assembly``
numbers them globally, inputs first, then aux.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

from masp_tpu_torch.groth16.params import Assembly
from masp_tpu_torch.host.r1cs.cs import lc, lc_var, var_input
from masp_tpu_torch.utils.tracing import span


def add_input_constraints(cs) -> None:
    """One x * 0 = 0 constraint per input, so that the IC query is dense
    (bellman's generator and prover both add them)."""
    for i in range(cs.num_inputs):
        cs.enforce("", lc_var(var_input(i)), lc(), lc())


def _u64x4(vals) -> np.ndarray:
    """Field elements -> (n, 4) uint64 little-endian rows."""
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype=np.uint64).reshape(len(vals), 4).copy()


def _csr(cs) -> tuple:
    """(indptr, var_idx, coeffs) of the A | B | C rows in insertion order,
    variables numbered globally."""
    rows = cs.a_rows + cs.b_rows + cs.c_rows
    indptr = np.zeros(len(rows) + 1, dtype=np.int64)
    np.cumsum([len(r) for r in rows], out=indptr[1:])
    v = np.fromiter((t[0] for r in rows for t in r), dtype=np.int64, count=int(indptr[-1]))
    var_idx = np.where(v % 2 == 0, v // 2, cs.num_inputs + v // 2)
    # the distinct coefficients are few: encode each once
    pos: dict[int, int] = {}
    idx = np.fromiter((pos.setdefault(t[1], len(pos)) for r in rows for t in r),
                      dtype=np.int64, count=int(indptr[-1]))
    table = _u64x4(sorted(pos, key=pos.get)) if pos else np.zeros((0, 4), np.uint64)
    return indptr, var_idx, table[idx]


def assembly_from_cs(cs) -> Assembly:
    """The port's Assembly of a ProvingAssembly, a TapeWitness (structure
    and assignment) or a KeypairAssembly (structure only)."""
    if hasattr(cs, "inputs_u64"):  # TapeWitness: its class's structure and value arrays
        assignment = np.concatenate([cs.inputs_u64, cs.aux_u64], axis=0)
        return dataclasses.replace(structure_assembly(cs.kind), assignment=assignment)
    indptr, var_idx, coeffs = _csr(cs)
    assignment = None
    if hasattr(cs, "aux_assignment"):
        assignment = _u64x4(cs.input_assignment + cs.aux_assignment)
    return Assembly(
        num_inputs=cs.num_inputs, num_vars=cs.num_inputs + cs.num_aux,
        num_constraints=cs.num_constraints, indptr=indptr, var_idx=var_idx, coeffs=coeffs,
        assignment=assignment,
    )


@functools.cache
def structure_assembly(kind) -> Assembly:
    """Structure-only Assembly of a circuit class (Spend, Output, Convert),
    input constraints included; built once per process, and its arrays are
    shared by every tape witness of the class (the prover only reads them)."""
    from masp_tpu_torch.host.circuits import witness_tape as WT

    return assembly_from_cs(WT.structure_for(kind))


def synthesize_witness(circuit, use_tape: bool = True) -> tuple[Assembly, str]:
    """(Assembly with the full assignment, route) of one circuit instance.
    The route is "tape" when the circuit's recorded witness tape was replayed
    in C++ (the first call per circuit class records it: seconds), else
    "python", the gadget walk, which ``use_tape=False`` asks for."""
    from masp_tpu_torch.host import native
    from masp_tpu_torch.host.circuits import witness_tape as WT
    from masp_tpu_torch.host.r1cs.cs import ProvingAssembly

    if use_tape and native.tape_available() and WT.supported(circuit) and WT.has_full_instance(circuit):
        with span("witness/tape"):
            return assembly_from_cs(WT.fast_witness(circuit)), "tape"
    with span("witness/python"):
        cs = ProvingAssembly()
        circuit.synthesize(cs)
        add_input_constraints(cs)
        return assembly_from_cs(cs), "python"


__all__ = [
    "add_input_constraints", "assembly_from_cs", "structure_assembly", "synthesize_witness",
]
