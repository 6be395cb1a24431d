# Copy of masp_tpu/groth16/structures.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""Groth16 parameter / proof structures with bellman-compatible
serialization (masp_proofs loads bellman ``Parameters::read`` files,
lib.rs:336; proofs are 48+96+48 compressed, transaction.rs:60)."""

from __future__ import annotations

import io
from dataclasses import dataclass, field

import numpy as np

from masp_tpu_torch.host.bls12_381 import (
    G1, G2, Fq12, multi_miller_loop, final_exponentiation, pairing,
)


@dataclass
class Proof:
    a: G1
    b: G2
    c: G1

    GROTH_PROOF_SIZE = 192

    def write(self) -> bytes:
        return self.a.to_compressed() + self.b.to_compressed() + self.c.to_compressed()

    @staticmethod
    def read(data: bytes, check_subgroup: bool = True) -> "Proof":
        if len(data) != 192:
            raise ValueError("proof must be 192 bytes")
        a = G1.from_compressed(data[0:48], check_subgroup)
        b = G2.from_compressed(data[48:144], check_subgroup)
        c = G1.from_compressed(data[144:192], check_subgroup)
        if a is None or b is None or c is None:
            raise ValueError("invalid proof encoding")
        if a.is_identity() or b.is_identity() or c.is_identity():
            raise ValueError("point at infinity in proof")
        return Proof(a, b, c)

    @staticmethod
    def try_read(data: bytes, check_subgroup: bool = True) -> "Proof | None":
        """Non-raising variant for untrusted bundle bytes: the reference's
        batch path rejects malformed proofs instead of erroring
        (masp_proofs/src/sapling/verifier/batch.rs:85-87)."""
        try:
            return Proof.read(data, check_subgroup)
        except (ValueError, TypeError):
            return None

    def __eq__(self, other):
        return self.a == other.a and self.b == other.b and self.c == other.c


@dataclass
class VerifyingKey:
    alpha_g1: G1
    beta_g1: G1
    beta_g2: G2
    gamma_g2: G2
    delta_g1: G1
    delta_g2: G2
    ic: list[G1]

    def write(self) -> bytes:
        out = io.BytesIO()
        out.write(self.alpha_g1.to_uncompressed())
        out.write(self.beta_g1.to_uncompressed())
        out.write(self.beta_g2.to_uncompressed())
        out.write(self.gamma_g2.to_uncompressed())
        out.write(self.delta_g1.to_uncompressed())
        out.write(self.delta_g2.to_uncompressed())
        out.write(len(self.ic).to_bytes(4, "big"))
        for p in self.ic:
            out.write(p.to_uncompressed())
        return out.getvalue()

    @staticmethod
    def read(r: io.BufferedIOBase) -> "VerifyingKey":
        def g1():
            p = G1.from_uncompressed(r.read(96))
            if p is None:
                raise ValueError("invalid G1 point")
            return p

        def g2():
            p = G2.from_uncompressed(r.read(192))
            if p is None:
                raise ValueError("invalid G2 point")
            return p

        alpha_g1 = g1()
        beta_g1 = g1()
        beta_g2 = g2()
        gamma_g2 = g2()
        delta_g1 = g1()
        delta_g2 = g2()
        ic_len = int.from_bytes(r.read(4), "big")
        ic = [g1() for _ in range(ic_len)]
        return VerifyingKey(alpha_g1, beta_g1, beta_g2, gamma_g2, delta_g1, delta_g2, ic)

    def __eq__(self, other):
        return (
            self.alpha_g1 == other.alpha_g1
            and self.beta_g1 == other.beta_g1
            and self.beta_g2 == other.beta_g2
            and self.gamma_g2 == other.gamma_g2
            and self.delta_g1 == other.delta_g1
            and self.delta_g2 == other.delta_g2
            and self.ic == other.ic
        )


@dataclass
class PreparedVerifyingKey:
    """Pairing precomputation (bellman prepare_verifying_key)."""

    alpha_g1_beta_g2: Fq12
    neg_gamma_g2: G2
    neg_delta_g2: G2
    ic: list[G1]
    # retained for the device-pairing batch path (alpha*beta as a pair)
    alpha_g1: G1 | None = None
    beta_g2: G2 | None = None


def prepare_verifying_key(vk: VerifyingKey) -> PreparedVerifyingKey:
    return PreparedVerifyingKey(
        alpha_g1_beta_g2=pairing(vk.alpha_g1, vk.beta_g2),
        neg_gamma_g2=-vk.gamma_g2,
        neg_delta_g2=-vk.delta_g2,
        ic=list(vk.ic),
        alpha_g1=vk.alpha_g1,
        beta_g2=vk.beta_g2,
    )


@dataclass
class Parameters:
    """Proving parameters.

    Host lists hold the affine points (bellman file order); ``device``
    optionally caches encoded limb arrays for the TPU prover.
    """

    vk: VerifyingKey
    h: list[G1]
    l: list[G1]
    a: list[G1]
    b_g1: list[G1]
    b_g2: list[G2]
    device: dict = field(default_factory=dict, compare=False, repr=False)

    def write(self) -> bytes:
        out = io.BytesIO()
        out.write(self.vk.write())
        for vec in (self.h, self.l, self.a, self.b_g1):
            out.write(len(vec).to_bytes(4, "big"))
            for p in vec:
                out.write(p.to_uncompressed())
        out.write(len(self.b_g2).to_bytes(4, "big"))
        for p in self.b_g2:
            out.write(p.to_uncompressed())
        return out.getvalue()

    @staticmethod
    def read(r: io.BufferedIOBase, checked: bool = False) -> "Parameters":
        vk = VerifyingKey.read(r)

        def read_g1_vec():
            n = int.from_bytes(r.read(4), "big")
            out = []
            for _ in range(n):
                p = G1.from_uncompressed(r.read(96), check_curve=checked)
                if p is None:
                    raise ValueError("invalid G1 point")
                out.append(p)
            return out

        h = read_g1_vec()
        l = read_g1_vec()
        a = read_g1_vec()
        b_g1 = read_g1_vec()
        n = int.from_bytes(r.read(4), "big")
        b_g2 = []
        for _ in range(n):
            p = G2.from_uncompressed(r.read(192), check_curve=checked)
            if p is None:
                raise ValueError("invalid G2 point")
            b_g2.append(p)
        return Parameters(vk, h, l, a, b_g1, b_g2)


__all__ = [
    "Proof", "VerifyingKey", "PreparedVerifyingKey", "prepare_verifying_key",
    "Parameters",
]
