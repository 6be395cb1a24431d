"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C interface,
compiled for sm_90a at first use into ``csrc/build/`` (listed in
.gitignore). Library names carry a hash of the sources, flags and
preprocessor defines, so an edited source is rebuilt and a variant built with
other defines (``library(name, defines)``, a measurement's build of a
compile-time choice) gets a library of its own. ``build_all`` starts one nvcc
per source and variant at once, which is how chip_smoke.py builds everything
inside its time limit. ptxas's register and spill report (``-Xptxas -v``) is
kept beside each library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("mont_mul", "point_add", "affine", "int8_dot", "mont_mul_mxu", "jubjub")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the toolkit is")
    return path


def _flags(defines: tuple[str, ...]) -> list[str]:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def _digest(name: str, defines: tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:12]


def lib_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name, defines)}.so"


def log_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    return lib_path(name, defines).with_suffix(".log")


def _start(name: str, defines: tuple[str, ...] = ()):
    """Start nvcc for one source; None when the library is already built."""
    out = lib_path(name, defines)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    log = open(log_path(name, defines), "w")
    cmd = [nvcc_path(), *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, log, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, log, tmp, out = started
    try:
        rc = proc.wait()
    finally:
        log.close()
    if rc != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu (rc {rc}):\n{Path(log.name).read_text()}"
        )
    os.replace(tmp, out)


def build_all(variants=()) -> None:
    """Compile every source, and each (name, defines) of ``variants``,
    concurrently (one nvcc each) and wait."""
    builds = [(n, ()) for n in SOURCES] + [(n, tuple(d)) for n, d in variants]
    with _LOCK:
        started = [(n, _start(n, d)) for n, d in builds]
        errors = []
        for n, s in started:
            try:
                _finish(n, s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def library(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``-D`` of each
    of ``defines``, built on first use."""
    key = (name, tuple(defines))
    lib = _LIBS.get(key)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(key)
        if lib is None:
            _finish(name, _start(name, key[1]))
            lib = ctypes.CDLL(str(lib_path(name, key[1])))
            _LIBS[key] = lib
    return lib


__all__ = ["build_all", "library", "lib_path", "log_path", "nvcc_path", "SOURCES"]
