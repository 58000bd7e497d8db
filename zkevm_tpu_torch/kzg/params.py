"""KZG commitment parameters (SRS) and commitments.

Port of ``zkevm_tpu/kzg/params.py`` (``ParamsKZG.unsafe_setup``,
``commit``, ``commit_lagrange``). The SRS is a device batch of Jacobian
points ``[tau^i] G1`` (``(n, 3, 8)``); commitments run the MSM of
``ec/msm.py`` on standard-form scalars. Pairing-side values (G2 points)
are host ints, used only by the verifier.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from zkevm_tpu_torch.device import resolve_device
from zkevm_tpu_torch.ec import goldens as g1g, group, pairing as pr
from zkevm_tpu_torch.ec.msm import MSM
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.poly import ntt as nttmod


@dataclass
class ParamsKZG:
    k: int
    g1_powers: torch.Tensor  # (n, 3, 8) [tau^i] G1
    g2: tuple  # host affine Fq2 pair
    s_g2: tuple  # [tau] G2
    committer: MSM = field(init=False, repr=False)

    def __post_init__(self):
        if self.g1_powers.shape != (1 << self.k, 3, ff.W):
            raise ValueError(f"g1_powers must be ({1 << self.k}, 3, 8)")
        self.committer = MSM(self.g1_powers)

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def device(self) -> torch.device:
        return self.g1_powers.device

    @classmethod
    def unsafe_setup(cls, k: int, tau: int = 0xDEAD_BEEF_CAFE, *, device=None) -> "ParamsKZG":
        """Test-only SRS from a known tau: the powers of tau by a prefix
        product, then one per-lane scalar multiplication of the generator
        (the reference's _srs_gen)."""
        device = resolve_device(device)
        n = 1 << k
        tau %= FR_MOD
        pows = ff.prefix_product(FR, FR.const(tau, device).expand(n, ff.W))  # [1, tau, ...]
        gen = group.from_affine_ints([g1g.G1_GEN], device)[0]
        g1_powers = group.scalar_mul(gen, ff.from_mont(FR, pows))
        s_g2 = pr.g2_scalar_mul(pr.G2_GEN, tau)
        return cls(k=k, g1_powers=g1_powers, g2=pr.G2_GEN, s_g2=s_g2)

    def commit(self, coeffs_mont: torch.Tensor) -> torch.Tensor:
        """Commit to a coefficient-form polynomial ((n, 8) Montgomery)."""
        return self.committer(ff.from_mont(FR, coeffs_mont))

    def commit_lagrange(self, evals_mont: torch.Tensor) -> torch.Tensor:
        return self.commit(nttmod.intt(evals_mont, self.k))
