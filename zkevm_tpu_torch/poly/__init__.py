"""Polynomial layer: radix-2 NTT/iNTT, evaluation domains, coset extension."""

from zkevm_tpu_torch.poly import domain, ntt
from zkevm_tpu_torch.poly.domain import Domain
from zkevm_tpu_torch.poly.ntt import coset_intt, coset_ntt, intt, ntt as fft  # noqa: F401

__all__ = ["Domain", "domain", "ntt", "intt", "coset_ntt", "coset_intt"]
