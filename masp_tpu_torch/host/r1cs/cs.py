# Copy of masp_tpu/r1cs/cs.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""R1CS constraint system over the BLS12-381 scalar field.

Replaces ``bellpepper-core``'s ConstraintSystem / LinearCombination /
TestConstraintSystem (SURVEY.md §2.4) for the TPU build.  Design notes:

- Variables are encoded as ints: input i -> 2*i, aux j -> 2*j + 1.  Sort
  order (inputs before aux, then by index) matches bellpepper's Index
  ordering so linear combinations are accumulated + sorted identically.
- Witness values are plain ints mod r (None = unknown, mirroring the
  reference's Option<Scalar> values during shape-only synthesis).
- Synthesis is structured so the same gadget code drives three backends:
  TestConstraintSystem (named constraints, satisfaction, structure hash),
  ProvingAssembly (sparse A/B/C + dense assignment for the Groth16 prover),
  and KeypairAssembly (shape only, for parameter generation).
"""

from __future__ import annotations

import hashlib

from masp_tpu_torch.host.fields import SCALAR_MODULUS

R = SCALAR_MODULUS

# Field constants used by gadget witness computation (ints mod R).


class SynthesisError(Exception):
    pass


class AssignmentMissing(SynthesisError):
    pass


class DivisionByZero(SynthesisError):
    pass


class Unsatisfiable(SynthesisError):
    pass


def var_input(i: int) -> int:
    return 2 * i


def var_aux(j: int) -> int:
    return 2 * j + 1


def var_is_input(v: int) -> bool:
    return v % 2 == 0


def var_index(v: int) -> int:
    return v // 2


ONE = var_input(0)  # CS::one() — input variable 0, always 1

# Structure-hash forensics only: when True, LinearCombinations also keep a
# raw (var, coeff) insertion log (tools/structure_hash_hunt.py).
TRACE_LC = False


class LinearCombination:
    """Sum of (variable, coefficient) terms; accumulates per-variable and
    iterates in (inputs, aux) sorted order, like bellpepper's Indexer.

    When the module flag TRACE_LC is set (structure-hash forensics only),
    every add_term is also appended to a raw insertion log so old
    bellman-style Vec<(Variable, Scalar)> semantics (duplicates kept,
    insertion order) can be reconstructed."""

    __slots__ = ("terms", "log")

    def __init__(self, terms: dict[int, int] | None = None, log=None):
        self.terms = dict(terms) if terms else {}
        if TRACE_LC:
            self.log = list(log) if log else []
        else:
            self.log = None

    def copy(self) -> "LinearCombination":
        return LinearCombination(self.terms, self.log)

    def add_term(self, var: int, coeff: int) -> "LinearCombination":
        c = (self.terms.get(var, 0) + coeff) % R
        self.terms[var] = c
        if TRACE_LC:
            self.log.append((var, coeff % R))
        return self

    # operator sugar: lc + var, lc + (coeff, var), lc + lc2, unary -
    def __add__(self, other):
        out = self.copy()
        return out.__iadd__(other)

    def __iadd__(self, other):
        if isinstance(other, LinearCombination):
            src = other.log if TRACE_LC else other.terms.items()
            for v, c in src:
                self.add_term(v, c)
        elif isinstance(other, tuple):
            coeff, var = other
            self.add_term(var, coeff)
        else:  # bare variable
            self.add_term(other, 1)
        return self

    def __sub__(self, other):
        out = self.copy()
        return out.__isub__(other)

    def __isub__(self, other):
        if isinstance(other, LinearCombination):
            src = other.log if TRACE_LC else other.terms.items()
            for v, c in src:
                self.add_term(v, -c)
        elif isinstance(other, tuple):
            coeff, var = other
            self.add_term(var, -coeff)
        else:
            self.add_term(other, -1)
        return self

    def __neg__(self):
        out = LinearCombination()
        src = self.log if TRACE_LC else self.terms.items()
        for v, c in src:
            out.add_term(v, -c)
        return out

    def scale(self, k: int) -> "LinearCombination":
        out = LinearCombination()
        k %= R
        src = self.log if TRACE_LC else self.terms.items()
        for v, c in src:
            out.add_term(v, c * k)
        return out

    def sorted_terms(self) -> list[tuple[int, int]]:
        """(var, coeff) sorted inputs-first then by index, zero coeffs kept
        (accumulation can cancel to zero; bellpepper keeps the slot)."""
        return sorted(
            self.terms.items(), key=lambda t: (t[0] % 2, t[0] // 2)
        )

    def evaluate(self, input_assignment: list[int], aux_assignment: list[int]) -> int:
        acc = 0
        for v, c in self.terms.items():
            if v % 2 == 0:
                acc += c * input_assignment[v // 2]
            else:
                acc += c * aux_assignment[v // 2]
        return acc % R


def lc() -> LinearCombination:
    return LinearCombination()


def lc_var(var: int, coeff: int = 1) -> LinearCombination:
    out = LinearCombination()
    out.add_term(var, coeff)
    return out


class _Namespace:
    """Context manager that pops the namespace component on exit."""

    __slots__ = ("cs",)

    def __init__(self, cs: "ConstraintSystem", name: str):
        self.cs = cs
        cs._push_namespace(name)

    def __enter__(self):
        return self.cs

    def __exit__(self, *exc):
        self.cs._pop_namespace()
        return False


class ConstraintSystem:
    """Base class: namespacing + allocation bookkeeping.

    Subclasses implement _on_alloc/_on_alloc_input/_on_enforce.
    """

    def __init__(self):
        self.num_inputs = 1  # ONE
        self.num_aux = 0
        self.num_constraints = 0
        self._path: list[str] = []

    # --- namespaces -------------------------------------------------------
    def namespace(self, name: str) -> _Namespace:
        return _Namespace(self, name)

    ns = namespace

    def _push_namespace(self, name: str):
        pass

    def _pop_namespace(self):
        pass

    # --- allocation -------------------------------------------------------
    def alloc(self, name: str, value: int | None) -> int:
        v = var_aux(self.num_aux)
        self.num_aux += 1
        self._on_alloc(name, v, None if value is None else value % R)
        return v

    def alloc_input(self, name: str, value: int | None) -> int:
        v = var_input(self.num_inputs)
        self.num_inputs += 1
        self._on_alloc_input(name, v, None if value is None else value % R)
        return v

    def enforce(self, name: str, a: LinearCombination, b: LinearCombination, c: LinearCombination):
        self.num_constraints += 1
        self._on_enforce(name, a, b, c)

    def one(self) -> int:
        return ONE

    # --- subclass hooks ---------------------------------------------------
    def _on_alloc(self, name, var, value):
        raise NotImplementedError

    def _on_alloc_input(self, name, var, value):
        raise NotImplementedError

    def _on_enforce(self, name, a, b, c):
        raise NotImplementedError


class ProvingAssembly(ConstraintSystem):
    """Records sparse A/B/C rows + the full assignment: the prover backend.

    The constraint matrices go to the QAP/NTT stage; assignments feed the
    MSMs (SURVEY.md §7 Phase 5).
    """

    def __init__(self):
        super().__init__()
        self.input_assignment: list[int] = [1]
        self.aux_assignment: list[int] = []
        self.a_rows: list[list[tuple[int, int]]] = []
        self.b_rows: list[list[tuple[int, int]]] = []
        self.c_rows: list[list[tuple[int, int]]] = []

    def _on_alloc(self, name, var, value):
        if value is None:
            raise AssignmentMissing(name)
        self.aux_assignment.append(value)

    def _on_alloc_input(self, name, var, value):
        if value is None:
            raise AssignmentMissing(name)
        self.input_assignment.append(value)

    def _on_enforce(self, name, a, b, c):
        # insertion order suffices: row evaluation and tau-evaluation are
        # order-independent (sorted order only matters for the test CS hash)
        self.a_rows.append(list(a.terms.items()))
        self.b_rows.append(list(b.terms.items()))
        self.c_rows.append(list(c.terms.items()))


class KeypairAssembly(ConstraintSystem):
    """Shape-only backend for parameter generation; values ignored.

    Also records, per variable, in which constraints it appears in A/B/C —
    the layout ``generate_random_parameters`` evaluates at tau.
    """

    def __init__(self):
        super().__init__()
        self.a_rows: list[list[tuple[int, int]]] = []
        self.b_rows: list[list[tuple[int, int]]] = []
        self.c_rows: list[list[tuple[int, int]]] = []

    def _on_alloc(self, name, var, value):
        pass

    def _on_alloc_input(self, name, var, value):
        pass

    def _on_enforce(self, name, a, b, c):
        self.a_rows.append(list(a.terms.items()))
        self.b_rows.append(list(b.terms.items()))
        self.c_rows.append(list(c.terms.items()))


class TestConstraintSystem(ConstraintSystem):
    """Introspectable backend mirroring bellperson's TestConstraintSystem:
    named constraints/variables, satisfaction checking, path get/set, and a
    structure hash over the constraint system (SURVEY.md §4.1)."""

    def __init__(self):
        super().__init__()
        self._path_stack: list[str] = []
        self.named_objects: dict[str, tuple[str, int]] = {"ONE": ("var", ONE)}
        self.constraints: list[tuple[LinearCombination, LinearCombination, LinearCombination, str]] = []
        self.input_assignment: list[int] = [1]
        self.aux_assignment: list[int] = []
        self.input_names: list[str] = ["ONE"]

    # namespaces
    def _push_namespace(self, name: str):
        self._path_stack.append(name)

    def _pop_namespace(self):
        self._path_stack.pop()

    def _compute_path(self, name: str) -> str:
        assert "/" not in name, "'/' is not allowed in names"
        return "/".join(self._path_stack + [name])

    def _set_named_obj(self, path: str, obj):
        if path in self.named_objects:
            raise ValueError(f"tried to create object at existing path: {path}")
        self.named_objects[path] = obj

    # hooks
    def _on_alloc(self, name, var, value):
        path = self._compute_path(name)
        self._set_named_obj(path, ("var", var))
        self.aux_assignment.append(value if value is not None else 0)

    def _on_alloc_input(self, name, var, value):
        path = self._compute_path(name)
        self._set_named_obj(path, ("var", var))
        self.input_assignment.append(value if value is not None else 0)
        self.input_names.append(path)

    def _on_enforce(self, name, a, b, c):
        path = self._compute_path(name)
        index = len(self.constraints)
        self._set_named_obj(path, ("constraint", index))
        self.constraints.append((a, b, c, path))

    # introspection
    def which_is_unsatisfied(self) -> str | None:
        for a, b, c, path in self.constraints:
            av = a.evaluate(self.input_assignment, self.aux_assignment)
            bv = b.evaluate(self.input_assignment, self.aux_assignment)
            cv = c.evaluate(self.input_assignment, self.aux_assignment)
            if (av * bv - cv) % R != 0:
                return path
        return None

    def is_satisfied(self) -> bool:
        return self.which_is_unsatisfied() is None

    def get(self, path: str) -> int:
        kind, v = self.named_objects[path]
        assert kind == "var", f"{path} is not a variable"
        if v % 2 == 0:
            return self.input_assignment[v // 2]
        return self.aux_assignment[v // 2]

    def set(self, path: str, value: int):
        kind, v = self.named_objects[path]
        assert kind == "var", f"{path} is not a variable"
        if v % 2 == 0:
            self.input_assignment[v // 2] = value % R
        else:
            self.aux_assignment[v // 2] = value % R

    def get_input(self, index: int, path: str) -> int:
        assert self.input_names[index] == path, (
            f"input {index} is named {self.input_names[index]}, not {path}"
        )
        return self.input_assignment[index]

    def hash(self) -> str:
        """Structure digest over (counts, every LC term), REPRODUCING the
        reference's ``cs.hash()`` exactly — all three circuits match the
        pinned digests (masp_proofs/src/circuit/sapling.rs:733,:1026,
        convert.rs:221; see tools/structure_hash_hunt.py for the
        serialization sweep that recovered the layout): BLAKE2s-256 of
        [num_inputs, num_aux, num_constraints] as u64 BE, then per
        constraint/per LC: merged terms with zero coefficients DROPPED,
        ordered inputs-ascending then aux-ascending, term count u64 BE,
        then 'I'/'A' + index u64 BE + coeff as 32 bytes BE."""
        h = hashlib.blake2s(digest_size=32)
        h.update(self.num_inputs.to_bytes(8, "big"))
        h.update(self.num_aux.to_bytes(8, "big"))
        h.update(len(self.constraints).to_bytes(8, "big"))
        for a, b, c, _path in self.constraints:
            for comb in (a, b, c):
                terms = [(v, k % R) for v, k in comb.sorted_terms() if k % R]
                h.update(len(terms).to_bytes(8, "big"))
                for v, coeff in terms:
                    tag = b"I" if v % 2 == 0 else b"A"
                    h.update(tag)
                    h.update((v // 2).to_bytes(8, "big"))
                    h.update(coeff.to_bytes(32, "big"))
        return h.hexdigest()

    def pretty_print(self) -> str:
        lines = []
        for _a, _b, _c, path in self.constraints:
            lines.append(path)
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Witness value helpers (int mod R, None = unknown). All gadget value
# computation flows through these so that a batched/TPU evaluation backend
# can swap in later.

def fval(x: int | None):
    return None if x is None else x % R


def fadd(*xs):
    acc = 0
    for x in xs:
        if x is None:
            return None
        acc += x
    return acc % R


def fsub(a, b):
    if a is None or b is None:
        return None
    return (a - b) % R


def fmul(a, b):
    if a is None or b is None:
        return None
    return (a * b) % R


def fneg(a):
    return None if a is None else (-a) % R


def finv(a):
    """Inverse; raises DivisionByZero on zero (matching bellman witness
    closures)."""
    if a is None:
        return None
    from masp_tpu_torch.host.r1cs import wit

    return wit.inv(a)


def fdiv(a, b):
    if a is None or b is None:
        return None
    return (a * finv(b)) % R


class MultiEq:
    """Batches equality constraints into few R1CS rows by packing with
    shifted powers of two until the field capacity is reached (bellman's
    MultiEq, used by the in-circuit BLAKE2s adder)."""

    CAPACITY = 254  # bls12-381 Scalar capacity

    def __init__(self, cs: ConstraintSystem):
        self.cs = cs
        self.ops = 0
        self.bits_used = 0
        self.lhs = LinearCombination()
        self.rhs = LinearCombination()

    def accumulate(self):
        self.cs.enforce(
            f"multieq {self.ops}", self.lhs, lc_var(ONE), self.rhs
        )
        self.lhs = LinearCombination()
        self.rhs = LinearCombination()
        self.bits_used = 0
        self.ops += 1

    def enforce_equal(self, num_bits: int, lhs: LinearCombination, rhs: LinearCombination):
        if self.bits_used + num_bits >= self.CAPACITY:
            self.accumulate()
        coeff = pow(2, self.bits_used, R)
        self.lhs += lhs.scale(coeff)
        self.rhs += rhs.scale(coeff)
        self.bits_used += num_bits

    def finalize(self):
        if self.bits_used > 0:
            self.accumulate()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.finalize()
        return False

    # pass-through so gadgets can treat MultiEq as a CS
    def namespace(self, name):
        return self.cs.namespace(name)

    ns = namespace

    def alloc(self, name, value):
        return self.cs.alloc(name, value)

    def alloc_input(self, name, value):
        return self.cs.alloc_input(name, value)

    def enforce(self, name, a, b, c):
        return self.cs.enforce(name, a, b, c)

    def one(self):
        return ONE


__all__ = [
    "R", "ONE", "SynthesisError", "AssignmentMissing", "DivisionByZero",
    "Unsatisfiable", "LinearCombination", "lc", "lc_var", "var_input",
    "var_aux", "var_is_input", "var_index", "ConstraintSystem",
    "ProvingAssembly", "KeypairAssembly", "TestConstraintSystem", "MultiEq",
    "fval", "fadd", "fsub", "fmul", "fneg", "finv", "fdiv",
]
