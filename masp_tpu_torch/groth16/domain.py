"""Radix-2 NTT evaluation domain over Fr.

Port of masp_tpu/groth16/domain.py: omega = ROOT_OF_UNITY^(2^(S - log2 m))
with the generator 7, coset shift 7, divide_by_z_on_coset multiplying by
(g^m - 1)^{-1} (bellman's EvaluationDomain). Transforms run log2(m)
butterfly stages over (m, 16) Montgomery limb tensors; every stage's
products go through the Fr Montgomery kernel in one call.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from masp_tpu_torch.host.fields import SCALAR_MODULUS
from masp_tpu_torch.ops import field as F
from masp_tpu_torch.ops.field import FR

R = SCALAR_MODULUS
GENERATOR = 7
TWO_ADICITY = 32
ROOT_OF_UNITY = pow(GENERATOR, (R - 1) >> TWO_ADICITY, R)


@lru_cache(maxsize=None)
def _powers_list(base: int, m: int) -> list[int]:
    out = [1] * m
    for i in range(1, m):
        out[i] = out[i - 1] * base % R
    return out


class Domain:
    """Size-m (power of two) evaluation domain with device tables."""

    def __init__(self, m: int, device="cuda"):
        if m & (m - 1) or m < 1:
            raise ValueError(f"domain size must be a power of two, got {m}")
        self.m = m
        self.device = torch.device(device)
        self.log_m = m.bit_length() - 1
        self.omega = pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - self.log_m), R)
        self.omega_inv = pow(self.omega, -1, R)
        self.m_inv = pow(m, -1, R)
        self.g = GENERATOR
        self.g_inv = pow(GENERATOR, -1, R)
        # Z(g * omega^i) = g^m - 1 (constant on the coset)
        self.z_on_coset = (pow(self.g, m, R) - 1) % R
        self.z_on_coset_inv = pow(self.z_on_coset, -1, R)
        self._tables: dict = {}

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr.astype(np.int32), device=self.device)

    def _cached(self, key, build):
        t = self._tables.get(key)
        if t is None:
            t = self._tables[key] = build()
        return t

    # --- tables (Montgomery limbs on the domain's device) -------------------
    def _twiddles(self, inverse: bool) -> list[torch.Tensor]:
        """Per-stage twiddles of the iterative DIT butterfly: stage s
        (half = 2^s) uses w^(m/(2^(s+1)) * j) for j < 2^s."""

        def build():
            w = self.omega_inv if inverse else self.omega
            pw = _powers_list(w, self.m // 2)
            return [
                self._dev(F.encode(FR, pw[:: self.m // (2 << s)][: 1 << s]))
                for s in range(self.log_m)
            ]

        return self._cached(("tw", inverse), build)

    def _bitrev(self) -> torch.Tensor:
        def build():
            rev = np.zeros(self.m, dtype=np.int64)
            idx = np.arange(self.m)
            for b in range(self.log_m):
                rev |= ((idx >> b) & 1) << (self.log_m - 1 - b)
            return torch.as_tensor(rev, device=self.device)

        return self._cached("bitrev", build)

    def _powers(self, base: int) -> torch.Tensor:
        """[base^i for i in range(m)] as Montgomery limbs."""
        return self._cached(
            ("pow", base), lambda: self._dev(F.encode(FR, _powers_list(base, self.m)))
        )

    def _scalar(self, x: int) -> torch.Tensor:
        return self._cached(("s", x), lambda: self._dev(F.encode(FR, [x])[0]))

    # --- transforms ----------------------------------------------------------
    def _fft_core(self, x, inverse: bool):
        """x: (..., m, L) Montgomery limbs -> transformed, same layout; the
        leading axes are independent transforms sharing every launch."""
        lead = x.shape[:-2]
        x = x[..., self._bitrev(), :]
        tws = self._twiddles(inverse)
        for s in range(self.log_m):
            half = 1 << s
            xr = x.reshape(lead + (self.m // (2 * half), 2, half, FR.L))
            even = xr[..., 0, :, :]
            odd = F.mont_mul(FR, xr[..., 1, :, :], tws[s][None, :, :])
            lo = F.add(FR, even, odd)
            hi = F.sub(FR, even, odd)
            x = torch.stack([lo, hi], dim=-3).reshape(lead + (self.m, FR.L))
        return x

    def fft(self, x):
        return self._fft_core(x, inverse=False)

    def ifft(self, x):
        y = self._fft_core(x, inverse=True)
        return F.mont_mul(FR, y, self._scalar(self.m_inv)[None, :])

    def coset_fft(self, x):
        """Evaluate on the coset g*H: scale coefficients by g^i, then fft."""
        return self.fft(F.mont_mul(FR, x, self._powers(self.g)))

    def icoset_fft(self, x):
        """Inverse of coset_fft."""
        return F.mont_mul(FR, self.ifft(x), self._powers(self.g_inv))

    def divide_by_z_on_coset(self, x):
        return F.mont_mul(FR, x, self._scalar(self.z_on_coset_inv)[None, :])


__all__ = ["Domain", "GENERATOR", "ROOT_OF_UNITY", "TWO_ADICITY"]
