# Copy of masp_tpu/native/__init__.py, verbatim apart from the build, marked below: the
# library is built with g++ at first use into build/ beside this file, named by a hash
# of the sources and flags (the source writes it beside its sources and rebuilds by
# mtime). The port imports nothing of masp_tpu.
"""Native (C++) host-side helpers, loaded via ctypes.

The compute path proper is JAX/Pallas on TPU; these cover host loops the
reference implements natively (rayon/SIMD): R1CS row evaluation feeding the
prover. Built on demand with g++; falls back to pure Python when no
compiler is available.
"""

from __future__ import annotations

import ctypes
# departs from the source: the build's hash and its atomic rename
import hashlib
import os
# end of departure
import pathlib
import subprocess

import numpy as np

_DIR = pathlib.Path(__file__).parent
# departs from the source: a build keyed by a hash of sources and flags
_BUILD = _DIR / "build"
_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")
_SOURCES = ("lc_eval.cpp", "witness_tape.cpp")


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in _SOURCES:
        h.update(s.encode())
        h.update((_DIR / s).read_bytes())
    return h.hexdigest()[:12]


_SO = _BUILD / f"libmasp_native-{_digest()}.so"
_LIB = None
_TRIED = False


def _build() -> bool:
    """g++ into a file of this process, then renamed into place, so that
    processes building at once never load a half-written library."""
    srcs = [str(_DIR / s) for s in _SOURCES]
    tmp = _SO.with_name(f"{_SO.name}.tmp{os.getpid()}")
    try:
        _BUILD.mkdir(exist_ok=True)
        subprocess.run(
            ["g++", *_FLAGS, "-o", str(tmp), *srcs],
            check=True,
            capture_output=True,
        )
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False


def _is_stale() -> bool:
    return not _SO.exists()
# end of departure


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if _is_stale() and not _build() and not _SO.exists():
        return None
    lib = ctypes.CDLL(str(_SO))
    lib.eval_lc_rows.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.u256_to_limbs16.argtypes = [
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32),
    ]
    try:
        lib.replay_tape.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.replay_tape.restype = ctypes.c_int64
        lib.compute_levels.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.replay_tape_leveled.argtypes = [
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int64,
        ]
        lib.replay_tape_leveled.restype = ctypes.c_int64
    except AttributeError:
        pass  # older .so without the tape interpreter
    _LIB = lib
    return lib


def _as_u64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def eval_lc_rows_native(indptr: np.ndarray, var_idx: np.ndarray,
                        coeffs: np.ndarray, assignment: np.ndarray) -> np.ndarray:
    """CSR linear-combination evaluation mod r.

    indptr (rows+1) int64; var_idx (nnz) int64; coeffs (nnz, 4) u64 LE;
    assignment (vars, 4) u64 LE. Returns (rows, 4) u64 LE."""
    lib = get_lib()
    assert lib is not None
    num_rows = len(indptr) - 1
    out = np.empty((num_rows, 4), dtype=np.uint64)
    lib.eval_lc_rows(
        indptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        var_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _as_u64_ptr(coeffs),
        _as_u64_ptr(assignment),
        num_rows,
        _as_u64_ptr(out),
    )
    return out


def available() -> bool:
    return get_lib() is not None


def tape_available() -> bool:
    lib = get_lib()
    return lib is not None and hasattr(lib, "replay_tape")


def leveled_available() -> bool:
    lib = get_lib()
    return lib is not None and hasattr(lib, "replay_tape_leveled")


def compute_levels_native(ops: np.ndarray) -> np.ndarray:
    """Per-op dependency level, (n,) int32 (see witness_tape.cpp)."""
    lib = get_lib()
    assert lib is not None
    ops = np.ascontiguousarray(ops, dtype=np.int64)
    n = ops.shape[0]
    out = np.empty(n, dtype=np.int32)
    lib.compute_levels(
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def replay_tape_leveled_native(ops: np.ndarray, offsets: np.ndarray,
                               consts: np.ndarray, inputs: np.ndarray,
                               min_par: int = 4096) -> np.ndarray:
    """Level-scheduled tape replay: ops sorted by dependency level (with
    renumbered operands), offsets (n_levels+1) int64 level boundaries.
    Wide levels run threaded. Returns all registers, (n, 4) u64 LE."""
    lib = get_lib()
    assert lib is not None
    n = ops.shape[0]
    ops = np.ascontiguousarray(ops, dtype=np.int64)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    consts = np.ascontiguousarray(consts, dtype=np.uint64)
    inputs = np.ascontiguousarray(inputs, dtype=np.uint64)
    out = np.empty((n, 4), dtype=np.uint64)
    rc = lib.replay_tape_leveled(
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        offsets.shape[0] - 1,
        _as_u64_ptr(consts),
        _as_u64_ptr(inputs),
        inputs.shape[0],
        _as_u64_ptr(out),
        min_par,
    )
    if rc != 0:
        raise ValueError(f"leveled tape replay failed at op {rc - 1} (zero inverse?)")
    return out


def replay_tape_native(ops: np.ndarray, consts: np.ndarray,
                       inputs: np.ndarray) -> np.ndarray:
    """Execute a witness tape (see r1cs/tape.py for the op set).

    ops (n, 3) int64; consts (k, 4) u64 LE; inputs (m, 4) u64 LE.
    Returns all registers as (n, 4) u64 LE. Raises ValueError if the tape
    hits a zero inverse."""
    lib = get_lib()
    assert lib is not None
    n = ops.shape[0]
    ops = np.ascontiguousarray(ops, dtype=np.int64)
    consts = np.ascontiguousarray(consts, dtype=np.uint64)
    inputs = np.ascontiguousarray(inputs, dtype=np.uint64)
    out = np.empty((n, 4), dtype=np.uint64)
    rc = lib.replay_tape(
        ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        _as_u64_ptr(consts),
        _as_u64_ptr(inputs),
        inputs.shape[0],
        _as_u64_ptr(out),
    )
    if rc != 0:
        raise ValueError(f"tape replay failed at op {rc - 1} (zero inverse?)")
    return out


__all__ = [
    "get_lib", "eval_lc_rows_native", "available",
    "tape_available", "replay_tape_native",
    "leveled_available", "compute_levels_native", "replay_tape_leveled_native",
]
