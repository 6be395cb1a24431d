# Copy of masp_tpu/groth16/embedded_vks.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""Embedded production verifying keys (masp_proofs/src/params.rs +
params/*.vk, feature `embed-verifying-key`).

The reference repo stores the three 1,636-byte VK files via git-LFS; this
build environment has the LFS *pointers* only (no network egress), so the
expected content hashes are pinned here and the loader accepts the real
files once present (e.g. fetched alongside the MPC parameters)."""

from __future__ import annotations

import hashlib
import io
import pathlib

from masp_tpu_torch.host.structures import VerifyingKey

# sha256 oids from the reference's LFS pointers (masp_proofs/params/*.vk)
SPEND_VK_SHA256 = "2dba395c5951ba56176ed2937c3c6b5163b9a9bd4658070bf938ac6f99176a56"
VK_SIZE = 1636

_SEARCH_DIRS = [
    pathlib.Path(__file__).parent / "params",
    pathlib.Path.home() / ".masp-params",
]


def _load(name: str) -> VerifyingKey | None:
    for d in _SEARCH_DIRS:
        p = d / name
        if p.exists():
            data = p.read_bytes()
            if data.startswith(b"version https://git-lfs"):
                continue  # LFS pointer, not the real key
            return VerifyingKey.read(io.BytesIO(data))
    return None


def spend_vk() -> VerifyingKey | None:
    """Production Spend VK, or None if masp-spend.vk is not materialized."""
    return _load("masp-spend.vk")


def output_vk() -> VerifyingKey | None:
    return _load("masp-output.vk")


def convert_vk() -> VerifyingKey | None:
    return _load("masp-convert.vk")


def verify_vk_file(path: pathlib.Path, expected_sha256: str) -> bool:
    return hashlib.sha256(path.read_bytes()).hexdigest() == expected_sha256


__all__ = ["spend_vk", "output_vk", "convert_vk", "verify_vk_file", "VK_SIZE"]
