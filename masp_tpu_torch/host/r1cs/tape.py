# Copy of masp_tpu/r1cs/tape.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""Witness tape: record circuit synthesis once, replay assignments fast.

The reference prover synthesizes the witness with bellperson's gadget
closures on every proof (rayon-parallel, SURVEY.md §3.1). Here the Python
gadget walk costs seconds per proof, so we record it ONCE per circuit kind
into a flat opcode tape and replay per proof in C++ (native/witness_tape.cpp)
or vectorized Python.

Recording: gadget witness values become TapeVal objects carrying (register
id, concrete value). Arithmetic operators emit ops; the concrete side runs
in lockstep so gadget assertions and tests keep working. Data-dependent
`if` on a TapeVal raises — those gadget sites use the helpers in
masp_tpu.r1cs.wit (select/lookup/bit), which emit branch-free ops.

Tape ops (registers are append-only; a/b are register ids unless noted):
  CONST idx        load constant table[idx]
  INPUT idx        load per-proof input idx
  ADD/SUB/MUL      mod-r field ops
  NEG              mod-r negation
  INV              modular inverse; zero input = replay error
  SHR k            logical shift right by immediate k (canonical value)
  XORW/ORW         bitwise on canonical values
  ANDC idx         bitwise AND with constant table[idx]
"""

from __future__ import annotations

import numpy as np

from masp_tpu_torch.host.fields import SCALAR_MODULUS

R = SCALAR_MODULUS

OP_CONST = 0
OP_INPUT = 1
OP_ADD = 2
OP_SUB = 3
OP_MUL = 4
OP_NEG = 5
OP_INV = 6
OP_SHR = 7
OP_XORW = 8
OP_ORW = 9
OP_ANDC = 10


class TapeBranchError(RuntimeError):
    """A gadget branched on a recorded witness value; rewrite the site with
    masp_tpu.r1cs.wit helpers (select/lookup/bit)."""


class TapeRecorder:
    def __init__(self):
        self.ops: list[tuple[int, int, int]] = []  # (opcode, a, b)
        self.consts: list[int] = []
        self._const_idx: dict[int, int] = {}
        self.num_inputs = 0
        # filled by the recording assembly:
        self.aux_regs: list[int] = []
        self.input_regs: list[int] = []

    # --- region helpers ----------------------------------------------------
    def _emit(self, op: int, a: int, b: int = 0) -> int:
        self.ops.append((op, a, b))
        return len(self.ops) - 1  # register id == op index

    def const(self, v: int) -> "TapeVal":
        v %= R
        idx = self._const_idx.get(v)
        if idx is None:
            idx = len(self.consts)
            self.consts.append(v)
            self._const_idx[v] = idx
        return TapeVal(self, self._emit(OP_CONST, idx), v)

    def input(self, concrete: int) -> "TapeVal":
        idx = self.num_inputs
        self.num_inputs += 1
        return TapeVal(self, self._emit(OP_INPUT, idx), concrete % R)

    def input_bool(self, concrete: bool) -> "TapeVal":
        return self.input(int(bool(concrete)))

    def _coerce(self, x) -> "TapeVal":
        if isinstance(x, TapeVal):
            return x
        return self.const(int(x))

    def finalize(self) -> "Tape":
        return Tape(
            ops=np.asarray(self.ops, dtype=np.int64).reshape(-1, 3),
            consts=_ints_to_u64x4(self.consts),
            num_inputs=self.num_inputs,
            aux_regs=np.asarray(self.aux_regs, dtype=np.int64),
            input_regs=np.asarray(self.input_regs, dtype=np.int64),
        )


class TapeVal:
    """Dual-track recorded value: tape register + concrete int (mod R)."""

    __slots__ = ("rec", "reg", "val")

    def __init__(self, rec: TapeRecorder, reg: int, val: int):
        self.rec = rec
        self.reg = reg
        self.val = val % R

    # --- field arithmetic --------------------------------------------------
    def _bin(self, op: int, other, concrete) -> "TapeVal":
        o = self.rec._coerce(other)
        return TapeVal(self.rec, self.rec._emit(op, self.reg, o.reg), concrete(self.val, o.val))

    def __add__(self, other):
        if isinstance(other, TapeVal) or isinstance(other, int):
            return self._bin(OP_ADD, other, lambda a, b: a + b)
        return NotImplemented

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return self._bin(OP_SUB, other, lambda a, b: a - b)

    def __rsub__(self, other):
        o = self.rec._coerce(other)
        return o.__sub__(self)

    def __mul__(self, other):
        if isinstance(other, TapeVal) or isinstance(other, int):
            return self._bin(OP_MUL, other, lambda a, b: a * b)
        return NotImplemented

    def __rmul__(self, other):
        return self.__mul__(other)

    def __neg__(self):
        return TapeVal(self.rec, self.rec._emit(OP_NEG, self.reg), -self.val)

    def __mod__(self, m):
        if m != R:
            raise TapeBranchError("TapeVal modulo only supports the field modulus")
        return self  # always reduced

    # --- canonical-bit ops (values < R; canonical little-endian bits) ------
    def __rshift__(self, k: int):
        return TapeVal(self.rec, self.rec._emit(OP_SHR, self.reg, int(k)), self.val >> k)

    def __lshift__(self, k: int):
        # shifted values stay below R at every gadget site (u32/u64 domain)
        v = self.val << k
        if v >= R:
            raise TapeBranchError("left shift overflows the field")
        return self.__mul__(1 << k)

    def __and__(self, mask: int):
        m = int(mask) % R
        self.rec.const(m)  # intern (emits a CONST op; harmless)
        idx = self.rec._const_idx[m]
        return TapeVal(self.rec, self.rec._emit(OP_ANDC, self.reg, idx), self.val & m)

    def __xor__(self, other):
        return self._bin(OP_XORW, other, lambda a, b: a ^ b)

    def __rxor__(self, other):
        return self.__xor__(other)

    def __or__(self, other):
        return self._bin(OP_ORW, other, lambda a, b: a | b)

    def __ror__(self, other):
        return self.__or__(other)

    def inv(self) -> "TapeVal":
        if self.val % R == 0:
            from masp_tpu_torch.host.r1cs.cs import DivisionByZero

            raise DivisionByZero()
        return TapeVal(self.rec, self.rec._emit(OP_INV, self.reg), pow(self.val, -1, R))

    # --- guards ------------------------------------------------------------
    def __bool__(self):
        raise TapeBranchError("data-dependent branch on a recorded witness value")

    def __eq__(self, other):
        if other is None:
            return False
        raise TapeBranchError("data-dependent comparison on a recorded witness value")

    def __hash__(self):
        raise TapeBranchError("TapeVal is unhashable")

    def __index__(self):
        raise TapeBranchError("data-dependent indexing on a recorded witness value")

    def __repr__(self):
        return f"TapeVal(reg={self.reg}, val={self.val})"


class Tape:
    """Finalized tape: numpy op arrays + output register maps."""

    def __init__(self, ops, consts, num_inputs, aux_regs, input_regs):
        self.ops = ops            # (n_ops, 3) int64
        self.consts = consts      # (n_consts, 4) u64 LE
        self.num_inputs = num_inputs
        self.aux_regs = aux_regs  # (num_aux,) int64
        self.input_regs = input_regs  # (num_inputs_cs - 1,) int64 (skips ONE)
        self._leveled_cache = None

    # ops with two register operands; the rest read register `a` only
    # (CONST/INPUT read no register: a is a const/input table index)
    _TWO_REG = (OP_ADD, OP_SUB, OP_MUL, OP_XORW, OP_ORW)

    def _leveled(self):
        """Level-scheduled form: (sorted_ops, level_offsets, input_regs',
        aux_regs') with operand registers renumbered to the sorted order.

        Ops on the same dependency level are independent, so the native
        replay executes each wide level across threads (the rayon shape of
        bellperson's parallel witness synthesis, SURVEY.md §3.1). Computed
        once per tape (cached; the tape itself is cached per circuit
        class)."""
        if self._leveled_cache is not None:
            return self._leveled_cache
        from masp_tpu_torch.host import native

        levels = native.compute_levels_native(self.ops)
        order = np.argsort(levels, kind="stable").astype(np.int64)
        new_index = np.empty_like(order)
        new_index[order] = np.arange(len(order), dtype=np.int64)

        ops = self.ops[order].copy()
        opc = ops[:, 0]
        reads_a = ~np.isin(opc, (OP_CONST, OP_INPUT))
        ops[reads_a, 1] = new_index[ops[reads_a, 1]]
        reads_b = np.isin(opc, self._TWO_REG)
        ops[reads_b, 2] = new_index[ops[reads_b, 2]]

        sorted_levels = levels[order]
        n_levels = int(sorted_levels[-1]) + 1 if len(sorted_levels) else 0
        offsets = np.searchsorted(
            sorted_levels, np.arange(n_levels + 1, dtype=np.int64)
        ).astype(np.int64)

        self._leveled_cache = (
            np.ascontiguousarray(ops), offsets,
            new_index[self.input_regs], new_index[self.aux_regs],
        )
        return self._leveled_cache

    def replay_py(self, inputs: list[int]) -> tuple[list[int], list[int]]:
        """Pure-Python replay (reference implementation for tests)."""
        assert len(inputs) == self.num_inputs
        regs = [0] * len(self.ops)
        consts = _u64x4_to_ints(self.consts)
        ops_list = [(int(r[0]), int(r[1]), int(r[2])) for r in self.ops]
        for i, (op, a, b) in enumerate(ops_list):
            if op == OP_CONST:
                regs[i] = consts[a]
            elif op == OP_INPUT:
                regs[i] = inputs[a] % R
            elif op == OP_ADD:
                regs[i] = (regs[a] + regs[b]) % R
            elif op == OP_SUB:
                regs[i] = (regs[a] - regs[b]) % R
            elif op == OP_MUL:
                regs[i] = (regs[a] * regs[b]) % R
            elif op == OP_NEG:
                regs[i] = (-regs[a]) % R
            elif op == OP_INV:
                if regs[a] == 0:
                    from masp_tpu_torch.host.r1cs.cs import DivisionByZero

                    raise DivisionByZero()
                regs[i] = pow(regs[a], -1, R)
            elif op == OP_SHR:
                regs[i] = regs[a] >> b
            elif op == OP_XORW:
                regs[i] = regs[a] ^ regs[b]
            elif op == OP_ORW:
                regs[i] = regs[a] | regs[b]
            elif op == OP_ANDC:
                regs[i] = regs[a] & consts[b]
            else:
                raise ValueError(f"bad opcode {op}")
        cs_inputs = [1] + [regs[r] for r in self.input_regs]
        aux = [regs[r] for r in self.aux_regs]
        return cs_inputs, aux

    def replay(self, inputs: list[int]):
        """Replay natively if available; returns (inputs_u64x4, aux_u64x4)
        numpy arrays including the leading ONE.

        MASP_TAPE_LEVELED=1 opts into the level-scheduled multithreaded
        replay. Measured NEUTRAL on a 4-core host (Spend 180 vs 183 ms):
        the tape's expensive ops (MUL/INV along the Pedersen chains) sit
        on the narrow critical path while the wide levels are cheap bit
        ops, so default stays sequential; the leveled path is for
        many-core hosts."""
        import os

        from masp_tpu_torch.host import native

        inp = _ints_to_u64x4([int(x) % R for x in inputs])
        if (
            native.leveled_available()
            and os.environ.get("MASP_TAPE_LEVELED", "0") == "1"
        ):
            ops, offsets, input_regs, aux_regs = self._leveled()
            regs = native.replay_tape_leveled_native(ops, offsets, self.consts, inp)
            ins = np.concatenate([_ints_to_u64x4([1]), regs[input_regs]], axis=0)
            return ins, regs[aux_regs]
        if native.tape_available():
            regs = native.replay_tape_native(self.ops, self.consts, inp)
            ins = np.concatenate(
                [_ints_to_u64x4([1]), regs[self.input_regs]], axis=0
            )
            aux = regs[self.aux_regs]
            return ins, aux
        cs_inputs, aux = self.replay_py([int(x) for x in inputs])
        return _ints_to_u64x4(cs_inputs), _ints_to_u64x4(aux)


def _ints_to_u64x4(vals) -> np.ndarray:
    buf = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(buf, dtype=np.uint64).reshape(len(vals), 4).copy()


def _u64x4_to_ints(arr) -> list[int]:
    return [int.from_bytes(arr[i].tobytes(), "little") for i in range(arr.shape[0])]


__all__ = [
    "TapeRecorder", "TapeVal", "Tape", "TapeBranchError",
    "OP_CONST", "OP_INPUT", "OP_ADD", "OP_SUB", "OP_MUL", "OP_NEG",
    "OP_INV", "OP_SHR", "OP_XORW", "OP_ORW", "OP_ANDC",
]
