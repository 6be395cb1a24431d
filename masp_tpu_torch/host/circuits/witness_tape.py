# Copy of masp_tpu/circuits/witness_tape.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""Per-circuit witness-tape recording and replay.

record_tape(kind) runs ONE Python synthesis of the given circuit with
TapeVal leaves and captures every witness computation as a flat opcode
tape (masp_tpu/r1cs/tape.py). replay then produces the full R1CS
assignment for any instance in C++ (native/witness_tape.cpp) in
milliseconds instead of seconds of Python gadget walking — the
replacement for bellperson's rayon-parallel synthesis closures
(SURVEY.md §3.1 HOT list).

The leaf specs below define the tape's input vector: the numeric values a
circuit instance feeds into gadget code, in a fixed order shared by
recording and per-proof extraction.
"""

from __future__ import annotations

from masp_tpu_torch.host.circuits.convert import Convert
from masp_tpu_torch.host.circuits.sapling import TREE_DEPTH, Output, Spend
from masp_tpu_torch.host.r1cs.cs import ProvingAssembly
from masp_tpu_torch.host.r1cs.tape import Tape, TapeRecorder


# --- recording doubles (duck-typed stand-ins for host curve objects) -------


class _RecAffine:
    __slots__ = ("n",)

    def __init__(self, n):
        self.n = n


class _RecPoint:
    __slots__ = ("u", "v")

    def __init__(self, u, v):
        self.u = u
        self.v = v

    def to_affine(self):
        return _RecAffine(self.u), _RecAffine(self.v)


class _RecScalar:
    __slots__ = ("n",)

    def __init__(self, n):
        self.n = n


class _RecPGK:
    __slots__ = ("ak", "nsk")

    def __init__(self, ak, nsk):
        self.ak = ak
        self.nsk = nsk


class _RecAddr:
    __slots__ = ("_g_d", "pk_d")

    def __init__(self, g_d, pk_d):
        self._g_d = g_d
        self.pk_d = pk_d

    def g_d(self):
        return self._g_d


class _RecVC:
    __slots__ = ("asset_generator", "value", "randomness")

    def __init__(self, asset_generator, value, randomness):
        self.asset_generator = asset_generator
        self.value = value
        self.randomness = randomness


class RecordingAssembly(ProvingAssembly):
    """ProvingAssembly that additionally maps every allocation to its tape
    register. Constraint rows are recorded too (harmless; the structure is
    discarded — the cached CSR from normal synthesis is reused)."""

    def __init__(self, rec: TapeRecorder):
        super().__init__()
        self.rec = rec

    def _reg_of(self, value):
        from masp_tpu_torch.host.r1cs.tape import TapeVal

        if isinstance(value, TapeVal):
            return value.reg
        return self.rec.const(int(value)).reg

    def _on_alloc(self, name, var, value):
        if value is None:
            raise ValueError(f"missing assignment for {name}")
        self.rec.aux_regs.append(self._reg_of(value))
        from masp_tpu_torch.host.r1cs.tape import TapeVal

        self.aux_assignment.append(
            value.val if isinstance(value, TapeVal) else value
        )

    def _on_alloc_input(self, name, var, value):
        if value is None:
            raise ValueError(f"missing assignment for {name}")
        self.rec.input_regs.append(self._reg_of(value))
        from masp_tpu_torch.host.r1cs.tape import TapeVal

        self.input_assignment.append(
            value.val if isinstance(value, TapeVal) else value
        )

    def _on_enforce(self, name, a, b, c):
        pass


# --- leaf specs ------------------------------------------------------------


def _point_leaves(rec, point):
    """Affine coords of a host ExtendedPoint as two tape inputs."""
    au, av = point.to_affine()
    return _RecPoint(rec.input(au.n), rec.input(av.n))


def _spend_recording_instance(rec: TapeRecorder, inst: Spend) -> Spend:
    ak = _point_leaves(rec, inst.proof_generation_key.ak)
    nsk = _RecScalar(rec.input(inst.proof_generation_key.nsk.n))
    ar = _RecScalar(rec.input(inst.ar.n))
    g_d = _point_leaves(rec, inst.payment_address.g_d())
    # pk_d is computed in-circuit for Spend; the double never exposes it
    addr = _RecAddr(g_d, None)
    vc = _RecVC(
        _point_leaves(rec, inst.value_commitment.asset_generator),
        rec.input(inst.value_commitment.value),
        _RecScalar(rec.input(inst.value_commitment.randomness.n)),
    )
    rcm = _RecScalar(rec.input(inst.commitment_randomness.n))
    auth_path = [
        (rec.input(s), rec.input_bool(b)) for (s, b) in inst.auth_path
    ]
    anchor = rec.input(inst.anchor)
    return Spend(
        value_commitment=vc,
        proof_generation_key=_RecPGK(ak, nsk),
        payment_address=addr,
        commitment_randomness=rcm,
        ar=ar,
        auth_path=auth_path,
        anchor=anchor,
    )


def _spend_leaves(inst: Spend) -> list[int]:
    out = []
    for p in (inst.proof_generation_key.ak,):
        au, av = p.to_affine()
        out += [au.n, av.n]
    out.append(inst.proof_generation_key.nsk.n)
    out.append(inst.ar.n)
    au, av = inst.payment_address.g_d().to_affine()
    out += [au.n, av.n]
    au, av = inst.value_commitment.asset_generator.to_affine()
    out += [au.n, av.n]
    out.append(inst.value_commitment.value)
    out.append(inst.value_commitment.randomness.n)
    out.append(inst.commitment_randomness.n)
    for s, b in inst.auth_path:
        out += [s, int(bool(b))]
    out.append(inst.anchor)
    return out


def _output_recording_instance(rec: TapeRecorder, inst: Output) -> Output:
    asset_id = [rec.input_bool(b) for b in inst.asset_identifier]
    vc = _RecVC(
        _point_leaves(rec, inst.value_commitment.asset_generator),
        rec.input(inst.value_commitment.value),
        _RecScalar(rec.input(inst.value_commitment.randomness.n)),
    )
    g_d = _point_leaves(rec, inst.payment_address.g_d())
    pk_d = _point_leaves(rec, inst.payment_address.pk_d)
    addr = _RecAddr(g_d, pk_d)
    rcm = _RecScalar(rec.input(inst.commitment_randomness.n))
    esk = _RecScalar(rec.input(inst.esk.n))
    return Output(
        value_commitment=vc,
        asset_identifier=asset_id,
        payment_address=addr,
        commitment_randomness=rcm,
        esk=esk,
    )


def _output_leaves(inst: Output) -> list[int]:
    out = [int(bool(b)) for b in inst.asset_identifier]
    au, av = inst.value_commitment.asset_generator.to_affine()
    out += [au.n, av.n]
    out.append(inst.value_commitment.value)
    out.append(inst.value_commitment.randomness.n)
    au, av = inst.payment_address.g_d().to_affine()
    out += [au.n, av.n]
    au, av = inst.payment_address.pk_d.to_affine()
    out += [au.n, av.n]
    out.append(inst.commitment_randomness.n)
    out.append(inst.esk.n)
    return out


def _convert_recording_instance(rec: TapeRecorder, inst: Convert) -> Convert:
    vc = _RecVC(
        _point_leaves(rec, inst.value_commitment.asset_generator),
        rec.input(inst.value_commitment.value),
        _RecScalar(rec.input(inst.value_commitment.randomness.n)),
    )
    auth_path = [
        (rec.input(s), rec.input_bool(b)) for (s, b) in inst.auth_path
    ]
    anchor = rec.input(inst.anchor)
    return Convert(value_commitment=vc, auth_path=auth_path, anchor=anchor)


def _convert_leaves(inst: Convert) -> list[int]:
    out = []
    au, av = inst.value_commitment.asset_generator.to_affine()
    out += [au.n, av.n]
    out.append(inst.value_commitment.value)
    out.append(inst.value_commitment.randomness.n)
    for s, b in inst.auth_path:
        out += [s, int(bool(b))]
    out.append(inst.anchor)
    return out


_SPECS = {
    Spend: (_spend_recording_instance, _spend_leaves),
    Output: (_output_recording_instance, _output_leaves),
    Convert: (_convert_recording_instance, _convert_leaves),
}

_TAPE_CACHE: dict[type, Tape] = {}
_STRUCT_CACHE: dict[type, object] = {}


class TapeWitness:
    """Array-native witness: quacks enough like ProvingAssembly for the
    prover (counts + structure via the cached shape-only assembly; values
    as (n, 4) u64 arrays straight from the C++ tape replay)."""

    __slots__ = (
        "kind", "structure", "inputs_u64", "aux_u64",
        "num_constraints", "num_inputs", "num_aux",
    )

    def __init__(self, kind, structure, inputs_u64, aux_u64):
        self.kind = kind
        self.structure = structure
        self.inputs_u64 = inputs_u64
        self.aux_u64 = aux_u64
        self.num_constraints = structure.num_constraints
        self.num_inputs = structure.num_inputs
        self.num_aux = structure.num_aux

    # int-list views (compat; used only by non-hot callers/tests)
    @property
    def input_assignment(self):
        from masp_tpu_torch.host.r1cs.tape import _u64x4_to_ints

        return _u64x4_to_ints(self.inputs_u64)

    @property
    def aux_assignment(self):
        from masp_tpu_torch.host.r1cs.tape import _u64x4_to_ints

        return _u64x4_to_ints(self.aux_u64)

    @property
    def a_rows(self):
        return self.structure.a_rows

    @property
    def b_rows(self):
        return self.structure.b_rows

    @property
    def c_rows(self):
        return self.structure.c_rows


def structure_for(kind) -> object:
    """Shape-only assembly (rows + counts) per circuit class, including the
    prover's input constraints — synthesized once per process."""
    cs = _STRUCT_CACHE.get(kind)
    if cs is None:
        from masp_tpu_torch.groth16.synthesis import add_input_constraints as _add_input_constraints
        from masp_tpu_torch.host.r1cs.cs import KeypairAssembly

        cs = KeypairAssembly()
        kind().synthesize(cs)
        _add_input_constraints(cs)
        _STRUCT_CACHE[kind] = cs
    return cs


def has_full_instance(circuit) -> bool:
    checks = {
        Spend: ("value_commitment", "proof_generation_key", "payment_address",
                "commitment_randomness", "ar", "anchor"),
        Output: ("value_commitment", "payment_address",
                 "commitment_randomness", "esk"),
        Convert: ("value_commitment", "anchor"),
    }[type(circuit)]
    return all(getattr(circuit, f) is not None for f in checks)


def fast_witness(circuit) -> TapeWitness:
    """Replay the (cached) tape for this instance natively."""
    kind = type(circuit)
    tape = record_tape(circuit)
    structure = structure_for(kind)
    ins, aux = tape.replay(leaves_for(circuit))
    return TapeWitness(kind, structure, ins, aux)


def record_tape(circuit) -> Tape:
    """Record (and cache per circuit class) the witness tape, using the
    given fully-populated instance for the recording run."""
    kind = type(circuit)
    tape = _TAPE_CACHE.get(kind)
    if tape is not None:
        return tape
    make_rec, _leaves = _SPECS[kind]
    rec = TapeRecorder()
    rec_inst = make_rec(rec, circuit)
    cs = RecordingAssembly(rec)
    rec_inst.synthesize(cs)
    tape = rec.finalize()
    tape.num_cs_inputs = cs.num_inputs
    tape.num_cs_aux = cs.num_aux
    _TAPE_CACHE[kind] = tape
    return tape


def leaves_for(circuit) -> list[int]:
    return _SPECS[type(circuit)][1](circuit)


def supported(circuit) -> bool:
    return type(circuit) in _SPECS


__all__ = [
    "record_tape", "leaves_for", "supported", "RecordingAssembly",
    "TapeWitness", "structure_for", "fast_witness", "has_full_instance",
]
