"""Evaluation domains for the PLONKish prover.

Port of ``zkevm_tpu/poly/domain.py``: a base 2^k domain for witness
columns and an extended coset domain of size 2^extended_k >= the quotient
degree. Transforms run on the tensor's device (kernels A and B).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FR_GENERATOR, FR_MOD, fr_root_of_unity
from zkevm_tpu_torch.poly import ntt as _ntt


@dataclass(frozen=True)
class Domain:
    """2^k base domain + 2^extended_k coset domain for degree-j quotients."""

    k: int
    extended_k: int

    @classmethod
    def new(cls, gate_degree: int, k: int) -> "Domain":
        """Like EvaluationDomain::new(j, k): the extended domain fits
        (j - 1) * n points (quotient degree)."""
        extended_k = k
        while (1 << extended_k) < (gate_degree - 1) * (1 << k) + 1:
            extended_k += 1
        return cls(k, extended_k)

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def extended_n(self) -> int:
        return 1 << self.extended_k

    @property
    def omega(self) -> int:
        return fr_root_of_unity(self.k)

    @property
    def extended_omega(self) -> int:
        return fr_root_of_unity(self.extended_k)

    @property
    def g_coset(self) -> int:
        """Multiplicative-generator coset shift for the extended domain."""
        return FR_GENERATOR

    def coeff_to_extended(self, coeffs: torch.Tensor) -> torch.Tensor:
        """(..., n, 8) coeffs -> (..., extended_n, 8) evals on g * <W>."""
        pad = coeffs.new_zeros(*coeffs.shape[:-2], self.extended_n - coeffs.shape[-2], ff.W)
        return _ntt.coset_ntt(torch.cat([coeffs, pad], dim=-2), self.g_coset)

    def extended_to_coeff(self, evals: torch.Tensor) -> torch.Tensor:
        """(..., extended_n, 8) coset evals -> extended-size coeffs."""
        return _ntt.coset_intt(evals, self.g_coset)

    def zh_inv_period(self, device) -> torch.Tensor:
        """1 / (X^n - 1) on the extended coset, one period: on g*W^i the
        value depends only on i mod (extended_n / n)."""
        period = self.extended_n // self.n
        w = self.extended_omega
        gn = pow(self.g_coset, self.n, FR_MOD)
        vals = []
        for i in range(period):
            zh = (gn * pow(w, self.n * i, FR_MOD) - 1) % FR_MOD
            vals.append(pow(zh, FR_MOD - 2, FR_MOD))
        return ff.to_tensor(FR.encode_many(vals), device)

    def divide_by_vanishing_poly(self, extended_evals: torch.Tensor) -> torch.Tensor:
        """Pointwise h(X) = e(X) / (X^n - 1) on the extended coset."""
        period = self.extended_n // self.n
        shape = extended_evals.shape
        e = extended_evals.reshape(*shape[:-2], self.n, period, ff.W)
        out = ff.mont_mul(FR, e, self.zh_inv_period(extended_evals.device))
        return out.reshape(shape)
