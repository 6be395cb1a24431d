"""Batched Montgomery arithmetic over 16-bit limb tensors.

Port of masp_tpu/ops/field_jax.py. An element is a (..., L) torch.int32
tensor of 16-bit limbs in Montgomery form (R = 2^(16 L)): L = 16 for Fr and
L = 24 for Fq, as in the JAX package. ``mont_mul`` runs the hand-written
kernel on CUDA tensors (kernels/mont_mul.py); add, sub and the rest are plain
PyTorch, widened to int64 where carries are propagated.
"""

from __future__ import annotations

import numpy as np
import torch

from masp_tpu_torch import device_const
from masp_tpu_torch.host.fields import FQ_MODULUS, SCALAR_MODULUS
from masp_tpu_torch.kernels import mont_mul as MK
from masp_tpu_torch.ops.limbs import (
    LIMB_BITS, add_limbs, int_to_limbs, ints_to_limbs, limbs_to_ints, reduce_once, sub_limbs,
)


class FieldSpec:
    """Static per-field constants for the limb arithmetic."""

    def __init__(self, name: str, modulus: int, n_limbs: int):
        self.name = name
        self.modulus = modulus
        self.L = n_limbs
        self.bits = n_limbs * LIMB_BITS
        self.R = 1 << self.bits
        if self.R <= modulus:
            raise ValueError("R must exceed the modulus")
        self.R_mod = self.R % modulus
        self.R2_mod = (self.R * self.R) % modulus
        # -N^{-1} mod 2^16
        self.n0inv = (-pow(modulus, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        # -N^{-1} mod R, for the plain version's whole-number reduction
        self.N_PRIME = int_to_limbs((-pow(modulus, -1, self.R)) % self.R, n_limbs)
        self.N = int_to_limbs(modulus, n_limbs)
        self.ONE_MONT = int_to_limbs(self.R_mod, n_limbs)
        self.R2_MONT = int_to_limbs(self.R2_mod, n_limbs)
        e = modulus - 2
        # exponent bits (MSB first) for Fermat inversion
        self.inv_exp_bits = [(e >> i) & 1 for i in range(e.bit_length() - 1, -1, -1)]
        # base-16 digits (MSB first) of N-2, for the 4-bit-window chain
        nnib = -(-e.bit_length() // 4)
        self.inv_exp_nibbles = [(e >> (4 * i)) & 0xF for i in range(nnib - 1, -1, -1)]

    def const(self, name: str, device) -> torch.Tensor:
        """(L,) int32 tensor of the limb constant ``name`` (e.g. "ONE_MONT")
        on a device, made once."""
        return device_const(
            (self.name, name, device),
            lambda: torch.as_tensor(getattr(self, name).astype(np.int32), device=device),
        )


FR = FieldSpec("Fr", SCALAR_MODULUS, 16)
FQ = FieldSpec("Fq", FQ_MODULUS, 24)


def _rows(spec, a, b):
    """Broadcast operands symmetrically; returns (shape, [(n, L) int64 rows])."""
    shape = a.shape[:-1] if a.shape == b.shape else torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    return shape, [
        x.expand(shape + (spec.L,)).reshape(-1, spec.L).to(torch.int64) for x in (a, b)
    ]


def mont_mul(spec: FieldSpec, a, b):
    """Montgomery product a*b*R^{-1} mod N on (..., L) limbs. Operands
    broadcast symmetrically, as ``pallas_mont_mul`` does: a constant (L,)
    times a batch works in either order (a one-sided broadcast once crashed
    the JAX package's batch_from_bytes with the batch on the right)."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    a2 = a.expand(shape + (spec.L,)).reshape(-1, spec.L).to(torch.int32).contiguous()
    b2 = b.expand(shape + (spec.L,)).reshape(-1, spec.L).to(torch.int32).contiguous()
    return MK.mont_mul(spec, a2, b2).reshape(shape + (spec.L,))


def mont_sqr(spec: FieldSpec, a):
    return mont_mul(spec, a, a)


def add(spec: FieldSpec, a, b):
    shape, (x, y) = _rows(spec, a, b)
    s, carry = add_limbs(x, y)
    return reduce_once(spec.const("N", x.device), s, carry).to(torch.int32).reshape(shape + (spec.L,))


def sub(spec: FieldSpec, a, b):
    """a - b mod N (canonical inputs); equals the JAX package's a + N - b
    followed by one conditional subtraction."""
    shape, (x, y) = _rows(spec, a, b)
    Nl = spec.const("N", x.device)
    d, borrow = sub_limbs(x, y)
    back, _ = add_limbs(d, Nl.expand_as(d))
    out = torch.where(borrow[:, None], back, d)
    return out.to(torch.int32).reshape(shape + (spec.L,))


def neg(spec: FieldSpec, a):
    return sub(spec, torch.zeros_like(a), a)


def select(cond, a, b):
    """cond ? a : b (cond: (...,) bool/int broadcast against the limb axis)."""
    return torch.where(cond[..., None] != 0, a, b)


def is_zero(a):
    return torch.all(a == 0, dim=-1)


def one_like(spec: FieldSpec, a):
    return spec.const("ONE_MONT", a.device).expand(a.shape).clone()


def mont_pow_fixed(spec: FieldSpec, a, exp_bits):
    """a^e in Montgomery form, e as an MSB-first bit list."""
    acc = one_like(spec, a)
    for bit in exp_bits:
        acc = mont_sqr(spec, acc)
        if bit:
            acc = mont_mul(spec, acc, a)
    return acc


def mont_inv(spec: FieldSpec, a):
    """Fermat inversion a^{N-2} (Montgomery in, Montgomery out)."""
    return mont_pow_fixed(spec, a, spec.inv_exp_bits)


def mont_inv_small(spec: FieldSpec, a):
    """Fermat inversion in 4-bit fixed windows: ceil(bits/4) rounds of four
    squarings and one table multiply (~475 dependent products instead of
    ~760). Bit-identical to mont_inv."""
    table = [one_like(spec, a), a]
    for _ in range(2, 16):
        table.append(mont_mul(spec, table[-1], a))
    nibs = spec.inv_exp_nibbles
    acc = table[nibs[0]]
    for nib in nibs[1:]:
        for _ in range(4):
            acc = mont_sqr(spec, acc)
        acc = mont_mul(spec, acc, table[nib])
    return acc


def batch_mont_inv(spec: FieldSpec, a):
    """Batch inversion over the leading axis: Hillis-Steele prefix products
    (log2(n) full-width multiplies), one Fermat inversion of the total, and
    the prefix/suffix unwind. Zero elements map to zero."""
    n = a.shape[0]
    one = one_like(spec, a)
    iz = is_zero(a)
    safe = torch.where(iz[..., None], one, a)
    steps = max(1, (n - 1).bit_length())

    def prefix(p):
        for k in range(steps):
            shift = 1 << k
            if shift >= n:
                break
            shifted = torch.cat([one[:shift], p[:-shift]], dim=0)
            p = mont_mul(spec, p, shifted)
        return p

    pre = prefix(safe)
    total_inv = mont_inv_small(spec, pre[-1])
    suffix = prefix(safe.flip(0)).flip(0)
    pfx_prev = torch.cat([one[:1], pre[:-1]], dim=0)
    sfx_next = torch.cat([suffix[1:], one[:1]], dim=0)
    invs = mont_mul(spec, mont_mul(spec, pfx_prev, sfx_next), total_inv)
    return torch.where(iz[..., None], torch.zeros_like(a), invs)


def to_mont(spec: FieldSpec, a):
    return mont_mul(spec, a, spec.const("R2_MONT", a.device))


def from_mont(spec: FieldSpec, a):
    one = torch.zeros(spec.L, dtype=torch.int32, device=a.device)
    one[0] = 1
    return mont_mul(spec, a, one)


# --- host codecs -----------------------------------------------------------

def encode(spec: FieldSpec, xs: list[int], mont: bool = True) -> np.ndarray:
    """ints -> (N, L) uint32 (Montgomery by default)."""
    if mont:
        xs = [(x % spec.modulus) * spec.R_mod % spec.modulus for x in xs]
    else:
        xs = [x % spec.modulus for x in xs]
    return ints_to_limbs(xs, spec.L)


def decode(spec: FieldSpec, arr, mont: bool = True) -> list[int]:
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    vals = limbs_to_ints(np.asarray(arr))
    if mont:
        rinv = pow(spec.R_mod, -1, spec.modulus)
        vals = [v * rinv % spec.modulus for v in vals]
    return vals


__all__ = [
    "FieldSpec", "FR", "FQ", "mont_mul", "mont_sqr", "add", "sub", "neg",
    "select", "is_zero", "one_like", "mont_pow_fixed", "mont_inv",
    "mont_inv_small", "batch_mont_inv", "to_mont", "from_mont", "encode",
    "decode",
]
