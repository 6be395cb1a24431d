"""Batched Montgomery arithmetic over 16-bit limb tensors.

Port of masp_tpu/ops/field_jax.py. An element is a (..., L) torch.int32
tensor of 16-bit limbs in Montgomery form (R = 2^(16 L)): L = 16 for Fr and
L = 24 for Fq, as in the JAX package. ``mont_mul`` runs the hand-written
kernel on CUDA tensors (kernels/mont_mul.py); add, sub and the rest are plain
PyTorch, widened to int64 where carries are propagated.
"""

from __future__ import annotations

from functools import partial

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
        self.n_prime = (-pow(modulus, -1, self.R)) % self.R
        self.N_PRIME = int_to_limbs(self.n_prime, n_limbs)
        self.N = int_to_limbs(modulus, n_limbs)
        self.ONE_MONT = int_to_limbs(self.R_mod, n_limbs)
        self.R2_MONT = int_to_limbs(self.R2_mod, n_limbs)
        self.ONE_RAW = int_to_limbs(1, n_limbs)  # from_mont's multiplier
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
    the JAX package's batch_from_bytes with the batch on the right). The
    broadcast views go to the kernel's wrapper as they are: it reads them
    through their row maps, without materialising them."""
    shape = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]) + (spec.L,)
    return MK.mont_mul(spec, a.to(torch.int32).expand(shape), b.to(torch.int32).expand(shape))


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
    """The inverse in Montgomery form, bit-identical to mont_inv and to the
    JAX package's mont_inv_small (4-bit fixed-window Fermat steps); 0 maps
    to 0. Runs the inversion kernel's wrapper (kernels/mont_mul.mont_inv, a
    divstep GCD): one launch on a CUDA tensor, its plain version on a CPU
    one."""
    rows = a.reshape(-1, spec.L).to(torch.int32).contiguous()
    return MK.mont_inv(spec, rows).reshape(a.shape)


def tree_batch_inv(spec: FieldSpec, d, mul=None, root_inv=None):
    """Exact batched inversion of w non-zero elements along axis 0, w a
    power of two: a product tree over contiguous halves (p[:h] * p[h:],
    w - 1 products in log2(w) launches), ``root_inv`` on the (1, ...) root
    (by default mont_inv_small), and the seeded
    down-sweep (2 (w - 1) products). ``mul`` defaults to mont_mul; the plain
    versions pass the plain product and root inverse.
    The inverse of a non-zero element is unique and fully reduced, so any
    tree shape gives the same limbs."""
    w = d.shape[0]
    if w == 0 or w & (w - 1):
        raise ValueError(f"the product-tree inversion takes a power-of-two lane count, got {w}")
    mul = mul or partial(mont_mul, spec)
    root_inv = root_inv or partial(mont_inv_small, spec)
    prods = [d]
    while prods[-1].shape[0] > 1:
        p = prods[-1]
        h = p.shape[0] // 2
        prods.append(mul(p[:h], p[h:]))
    inv = root_inv(prods[-1])
    for p in reversed(prods[:-1]):
        h = p.shape[0] // 2
        inv = torch.cat([mul(inv, p[h:]), mul(inv, p[:h])], dim=0)
    return inv


def batch_mont_inv(spec: FieldSpec, a):
    """Batch inversion over the leading axis of any length: zeros become
    ones and the batch is padded with ones to a power of two for
    tree_batch_inv (one inversion kernel launch on the root). Zero elements
    map to zero."""
    n = a.shape[0]
    one = one_like(spec, a)
    iz = is_zero(a)
    safe = torch.where(iz[..., None], one, a)
    w = 1 << (n - 1).bit_length()
    if w > n:
        safe = torch.cat([safe, one[:1].expand((w - n,) + a.shape[1:])], dim=0)
    invs = tree_batch_inv(spec, safe)
    return torch.where(iz[..., None], torch.zeros_like(a), invs[:n])


def to_mont(spec: FieldSpec, a):
    return mont_mul(spec, a, spec.const("R2_MONT", a.device))


def from_mont(spec: FieldSpec, a):
    return mont_mul(spec, a, spec.const("ONE_RAW", a.device))


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
    "mont_inv_small", "tree_batch_inv", "batch_mont_inv", "to_mont", "from_mont", "encode",
    "decode",
]
