# Copy of masp_tpu/circuits/constants.py, verbatim apart from import paths; the port imports
# nothing of masp_tpu.
"""Circuit-side constants: Edwards d, Montgomery A/scale, fixed-base window
tables and Pedersen circuit generators (Montgomery form).

Mirrors masp_proofs/src/constants.rs.  All tables are derived from the
masp_tpu.primitives generators (which are themselves derived via group_hash
and pinned against the reference's coordinates).
"""

from __future__ import annotations

from functools import lru_cache

from masp_tpu_torch.host.jubjub import EDWARDS_D as _D, ExtendedPoint
from masp_tpu_torch.host.fields import SCALAR_MODULUS, Scalar
from masp_tpu_torch.host.primitives.constants import (
    PEDERSEN_HASH_CHUNKS_PER_GENERATOR,
    note_commitment_randomness_generator,
    nullifier_position_generator,
    pedersen_hash_generators,
    proof_generation_key_generator,
    spending_key_generator,
    value_commitment_randomness_generator,
)

R = SCALAR_MODULUS

EDWARDS_D = _D.n

# Birationally equivalent Montgomery curve constants (constants.rs:20-40):
# A = 40962, scale = sqrt(4 / (a - d)) with a = -1.
MONTGOMERY_A = 40962


def _compute_montgomery_scale() -> int:
    # scale^2 * (-1 - d) = 4
    s2 = (4 * pow((-1 - EDWARDS_D) % R, -1, R)) % R
    s = Scalar(s2).sqrt()
    assert s is not None
    # Pin the same root as the reference (masp_proofs/src/constants.rs:32-40)
    # — the sign must match or in-circuit Pedersen results flip vs native.
    ref = 0x2762DE61E862645E31DE341E77D764E5CE4069703DA88ABD8F4535F7CF82B8D9
    if s.n != ref:
        s = -s
    assert s.n == ref
    return s.n


MONTGOMERY_SCALE = _compute_montgomery_scale()

FIXED_BASE_CHUNKS_PER_GENERATOR = 84


def to_montgomery_coords(g: ExtendedPoint) -> tuple[int, int] | None:
    """Edwards -> scaled Montgomery map (constants.rs:99-137)."""
    u, v = g.to_affine()
    x, y = u.n, v.n
    if y == 1:
        return None  # neutral element -> point at infinity
    if x == 0:
        return (0, 0)  # the affine point of order 2
    mu = ((1 + y) * pow((1 - y) % R, -1, R)) % R
    mv = (mu * pow(x, -1, R)) % R
    return (mu, (mv * MONTGOMERY_SCALE) % R)


def generate_circuit_generator(gen: ExtendedPoint) -> list[list[tuple[int, int]]]:
    """3-bit window table [identity, g, 2g, ..., 7g] for 84 magnitudes
    (constants.rs:76-94)."""
    windows = []
    for _ in range(FIXED_BASE_CHUNKS_PER_GENERATOR):
        coeffs = [(0, 1)]
        g = gen
        for _ in range(7):
            u, v = g.to_affine()
            coeffs.append((u.n, v.n))
            g = g + gen
        windows.append(coeffs)
        gen = g  # g is now 8 * original gen
    return windows


@lru_cache(maxsize=None)
def SPENDING_KEY_GENERATOR_TABLE():
    return generate_circuit_generator(spending_key_generator())


@lru_cache(maxsize=None)
def PROOF_GENERATION_KEY_GENERATOR_TABLE():
    return generate_circuit_generator(proof_generation_key_generator())


@lru_cache(maxsize=None)
def NOTE_COMMITMENT_RANDOMNESS_GENERATOR_TABLE():
    return generate_circuit_generator(note_commitment_randomness_generator())


@lru_cache(maxsize=None)
def NULLIFIER_POSITION_GENERATOR_TABLE():
    return generate_circuit_generator(nullifier_position_generator())


@lru_cache(maxsize=None)
def VALUE_COMMITMENT_RANDOMNESS_GENERATOR_TABLE():
    return generate_circuit_generator(value_commitment_randomness_generator())


@lru_cache(maxsize=None)
def PEDERSEN_CIRCUIT_GENERATORS() -> list[list[list[tuple[int, int]]]]:
    """2-bit window tables [g, 2g, 3g, 4g] in Montgomery coordinates for each
    chunk position of each Pedersen segment generator (constants.rs:141-173)."""
    out = []
    for gen in pedersen_hash_generators():
        windows = []
        for _ in range(PEDERSEN_HASH_CHUNKS_PER_GENERATOR):
            coeffs = []
            g = gen
            for _ in range(4):
                mc = to_montgomery_coords(g)
                assert mc is not None, "never the point at infinity"
                coeffs.append(mc)
                g = g + gen
            windows.append(coeffs)
            for _ in range(4):
                gen = gen.double()
        out.append(windows)
    return out


__all__ = [
    "EDWARDS_D", "MONTGOMERY_A", "MONTGOMERY_SCALE",
    "FIXED_BASE_CHUNKS_PER_GENERATOR", "to_montgomery_coords",
    "generate_circuit_generator",
    "SPENDING_KEY_GENERATOR_TABLE", "PROOF_GENERATION_KEY_GENERATOR_TABLE",
    "NOTE_COMMITMENT_RANDOMNESS_GENERATOR_TABLE",
    "NULLIFIER_POSITION_GENERATOR_TABLE",
    "VALUE_COMMITMENT_RANDOMNESS_GENERATOR_TABLE",
    "PEDERSEN_CIRCUIT_GENERATORS",
]
