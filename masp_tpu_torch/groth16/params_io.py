# Copy of masp_tpu/groth16/params_io.py, verbatim apart from import paths and the
# blocks marked below: a file's host Parameters become the port's (params_from_host)
# where they are loaded, and go back (params_to_host) where they are written. The
# port imports nothing of masp_tpu.
"""MASP parameter file management (masp_proofs/src/lib.rs): file names,
BLAKE2b hashes, byte sizes, load/verify, download stub (this environment has
no egress; tests/benches use freshly generated parameters, exactly like the
reference's benches)."""

from __future__ import annotations

import hashlib
import io
import os
import pathlib
import pickle

from masp_tpu_torch.host.structures import Parameters, prepare_verifying_key
# departs from the source: the port's Parameters from and to the host's
from masp_tpu_torch.groth16.params import params_from_host, params_to_host
# end of departure

MASP_SPEND_NAME = "masp-spend.params"
MASP_OUTPUT_NAME = "masp-output.params"
MASP_CONVERT_NAME = "masp-convert.params"

MASP_SPEND_HASH = (
    "196e7c717f25e16653431559ce2c8816e750a4490f98696e3c031efca37e25e0"
    "647182b7b013660806db11eb2b1e365fb2d6a0f24dbbd9a4a8314fef10a7cba2"
)
MASP_OUTPUT_HASH = (
    "eafc3b1746cccc8b9eed2b69395692c5892f6aca83552a07dceb2dcbaa64dcd0"
    "e22434260b3aa3b049b633a08b008988cbe0d31effc77e2bc09bfab690a23724"
)
MASP_CONVERT_HASH = (
    "dc4aaf3c3ce056ab448b6c4a7f43c1d68502c2902ea89ab8769b1524a2e8ace9"
    "a5369621a73ee1daa52aec826907a19974a37874391cf8f11bbe0b0420de1ab7"
)

MASP_SPEND_BYTES = 49848572
MASP_CONVERT_BYTES = 22570940
MASP_OUTPUT_BYTES = 16398620

DOWNLOAD_URL = (
    "https://github.com/anoma/masp-mpc/releases/download/namada-trusted-setup/"
)


class ParameterError(Exception):
    pass


def default_params_folder() -> pathlib.Path:
    return pathlib.Path(os.path.expanduser("~/.masp-params"))


def verify_file_size(path: pathlib.Path, expected: int, name: str) -> None:
    actual = path.stat().st_size
    if actual != expected:
        raise ParameterError(
            f"{name}: parameter file is {actual} bytes, expected {expected}"
        )


def _load_one(path: pathlib.Path, expected_hash: str, expected_bytes: int | None):
    if expected_bytes is not None:
        verify_file_size(path, expected_bytes, path.name)
    data = path.read_bytes()
    h = hashlib.blake2b(data, digest_size=64).hexdigest()
    if h != expected_hash:
        raise ParameterError(
            f"{path.name}: hash {h} does not match expected {expected_hash}"
        )
    params = Parameters.read(io.BytesIO(data), checked=False)
    # departs from the source: the port's Parameters
    params = params_from_host(params)
    # end of departure
    return params


class MASPParameters:
    """The three circuits' parameters + prepared verifying keys
    (lib.rs:266-273)."""

    def __init__(self, spend_params, spend_vk, output_params, output_vk,
                 convert_params, convert_vk):
        self.spend_params = spend_params
        self.spend_vk = spend_vk
        self.output_params = output_params
        self.output_vk = output_vk
        self.convert_params = convert_params
        self.convert_vk = convert_vk


def load_parameters(
    spend_path: pathlib.Path,
    output_path: pathlib.Path,
    convert_path: pathlib.Path,
    check_sizes: bool = True,
) -> MASPParameters:
    """Load and verify the three production parameter files (lib.rs:278-325).

    Verifies file sizes and BLAKE2b-512 whole-file hashes, parses bellman
    Parameters format, and prepares the verifying keys."""
    spend = _load_one(
        spend_path, MASP_SPEND_HASH, MASP_SPEND_BYTES if check_sizes else None
    )
    output = _load_one(
        output_path, MASP_OUTPUT_HASH, MASP_OUTPUT_BYTES if check_sizes else None
    )
    convert = _load_one(
        convert_path, MASP_CONVERT_HASH, MASP_CONVERT_BYTES if check_sizes else None
    )
    return MASPParameters(
        spend_params=spend,
        spend_vk=prepare_verifying_key(spend.vk),
        output_params=output,
        output_vk=prepare_verifying_key(output.vk),
        convert_params=convert,
        convert_vk=prepare_verifying_key(convert.vk),
    )


def fetch_params(
    name: str,
    expected_hash: str,
    expected_bytes: int,
    timeout=None,
    params_dir: pathlib.Path | None = None,
    opener=None,
) -> pathlib.Path:
    """Download one parameter file if missing, and always verify size and
    hash (lib.rs:143-209 fetch_params). The download streams through
    HashReader to disk in 1 MiB chunks (never whole-file in memory,
    lib.rs:216-262); a failed or corrupted download is deleted.

    ``opener`` overrides the HTTP opener (tests; environments without
    egress can point it at a local mirror)."""
    from masp_tpu_torch.host.downloadreader import ResponseLazyReader, urllib_opener
    from masp_tpu_torch.host.hashreader import HashReader

    params_dir = params_dir or default_params_folder()
    params_dir.mkdir(parents=True, exist_ok=True)
    path = params_dir / name

    if not path.exists():
        if opener is None:
            opener = urllib_opener(DOWNLOAD_URL + name, timeout=timeout)
        reader = HashReader(ResponseLazyReader(opener))
        try:
            with open(path, "wb") as out:
                # take(expected_bytes) semantics: never read past the
                # expected size (DoS guard, lib.rs:247-248)
                while reader.byte_count < expected_bytes:
                    n = min(1024 * 1024, expected_bytes - reader.byte_count)
                    chunk = reader.read(n)
                    if not chunk:
                        break
                    out.write(chunk)
            if reader.byte_count != expected_bytes:
                raise ParameterError(
                    f"{name}: downloaded {reader.byte_count} bytes, "
                    f"expected {expected_bytes}"
                )
            digest = reader.into_hash()
            if digest != expected_hash:
                raise ParameterError(
                    f"{name}: downloaded file hash {digest} does not match "
                    f"expected {expected_hash}"
                )
        except BaseException:
            path.unlink(missing_ok=True)  # never leave partial files behind
            raise
        return path

    # existing file: verify size first (cheap), then streaming hash
    verify_file_size(path, expected_bytes, name)
    with open(path, "rb") as f:
        reader = HashReader(f)
        while reader.read(1024 * 1024):
            pass
    digest = reader.into_hash()
    if digest != expected_hash:
        raise ParameterError(
            f"{name}: file hash {digest} does not match expected "
            f"{expected_hash}; clean your MASP parameters directory"
        )
    return path


def download_masp_parameters(timeout=None, params_dir=None, opener=None):
    """Download the three MPC parameter files if needed and verify them
    (lib.rs:121-141). Returns the three paths (spend, output, convert).

    Note: this build environment has zero egress — pass ``opener`` (a
    ``name -> () -> file-like`` factory) for a local mirror, or place
    pre-fetched files in ``default_params_folder()``."""
    paths = []
    for name, h, b in (
        (MASP_SPEND_NAME, MASP_SPEND_HASH, MASP_SPEND_BYTES),
        (MASP_OUTPUT_NAME, MASP_OUTPUT_HASH, MASP_OUTPUT_BYTES),
        (MASP_CONVERT_NAME, MASP_CONVERT_HASH, MASP_CONVERT_BYTES),
    ):
        paths.append(
            fetch_params(
                name, h, b, timeout=timeout, params_dir=params_dir,
                opener=None if opener is None else opener(name),
            )
        )
    return tuple(paths)


# --- generated-parameter cache (test/bench path) ---------------------------

def cached_test_params(name: str, circuit_factory, rng, cache_dir=None) -> Parameters:
    """Generate-once-and-cache test parameters for a circuit (the reference
    benches regenerate per run, masp_proofs/benches/sapling.rs:24-36; we cache
    to disk because TPU param generation is a one-time cost)."""
    cache_dir = pathlib.Path(cache_dir or ".params_cache")
    cache_dir.mkdir(exist_ok=True)
    # Key the cache by the circuit's structure digest: parameters encode the
    # QAP densities, so any change to constraint/LC layout silently
    # invalidates them (learned the hard way — a gadget LC fix shifted
    # params.a length and broke proving against stale files).
    from masp_tpu_torch.host.r1cs.cs import TestConstraintSystem

    shape_cs = TestConstraintSystem()
    circuit_factory().synthesize(shape_cs)
    digest = shape_cs.hash()[:12]
    path = cache_dir / f"{name}-{digest}.params"
    # sidecar cache of the device-layout point rows (prover
    # prepare_device_params): skips ~0.5M Python-int -> limb conversions
    # per fresh process; "v2" = per-query power-of-two pads
    rows_cache = cache_dir / f"{name}-{digest}.rows-v2.npz"
    if path.exists():
        with open(path, "rb") as f:
            params = Parameters.read(f, checked=False)
        # departs from the source: the port's Parameters
        params = params_from_host(params)
        # end of departure
        params.rows_cache = str(rows_cache)
        return params
    from masp_tpu_torch.groth16.generator import generate_random_parameters

    params = generate_random_parameters(circuit_factory(), rng)
    # atomic publish: generation takes minutes on device — a crash mid-write
    # must not leave a truncated file the next run would trust
    tmp = path.with_suffix(f".tmp-{os.getpid()}")
    # departs from the source: written as the host's Parameters
    tmp.write_bytes(params_to_host(params).write())
    # end of departure
    os.replace(tmp, path)
    params.rows_cache = str(rows_cache)
    return params


__all__ = [
    "MASP_SPEND_NAME", "MASP_OUTPUT_NAME", "MASP_CONVERT_NAME",
    "MASP_SPEND_HASH", "MASP_OUTPUT_HASH", "MASP_CONVERT_HASH",
    "MASP_SPEND_BYTES", "MASP_OUTPUT_BYTES", "MASP_CONVERT_BYTES",
    "ParameterError", "default_params_folder", "verify_file_size",
    "load_parameters", "download_masp_parameters", "MASPParameters",
    "cached_test_params",
]
