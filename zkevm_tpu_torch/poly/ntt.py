"""Radix-2 NTT / iNTT over BN254 Fr (kernel B and its plain version).

Port of ``zkevm_tpu/poly/ntt.py`` (``_fft_core``, ``ntt``, ``intt``,
``scale_by_powers``, ``coset_ntt``, ``coset_intt``). Arrays have shape
``(..., n, 8)``: leading dimensions batch several polynomials through one
transform. On CUDA the transform is the kernel in ``csrc/ntt.cu``; on the
CPU the plain version below repeats the reference's stage loop with the
field's plain arithmetic. Twiddle and power tables are built on the
tensor's device by a prefix product (kernel A), cached per size.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from zkevm_tpu_torch import kernels
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FR_MOD, fr_root_of_unity

SHARED_LOG = 10  # stages run in shared memory: tiles of 2^10 elements


def power_table(base: int, n: int, device) -> torch.Tensor:
    """(n, 8) Montgomery powers base^i, i < n, built on ``device``."""
    b = FR.const(base, device)
    return ff.prefix_product(FR, b.expand(n, ff.W))


@lru_cache(maxsize=32)
def _omega_powers(k: int, inverse: bool, device: str) -> torch.Tensor:
    omega = fr_root_of_unity(k)
    if inverse:
        omega = pow(omega, FR_MOD - 2, FR_MOD)
    return power_table(omega, max((1 << k) // 2, 1), device)


@lru_cache(maxsize=32)
def _bitrev_perm(k: int, device: str) -> torch.Tensor:
    idx = torch.arange(1 << k, dtype=torch.int64)
    rev = torch.zeros_like(idx)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev.to(device)


def _plain_fft(a: torch.Tensor, k: int, tw: torch.Tensor) -> torch.Tensor:
    n = 1 << k
    batch = a.shape[:-2]
    a = a.index_select(-2, _bitrev_perm(k, str(a.device)))
    for s in range(1, k + 1):
        m = 1 << s
        half = m // 2
        w = tw[:: n // m][:half]
        x = a.reshape(*batch, n // m, 2, half, ff.W)
        even = x[..., 0, :, :]
        odd = ff.PLAIN["mul"](FR, x[..., 1, :, :], w)
        a = torch.cat([ff.PLAIN["add"](FR, even, odd), ff.PLAIN["sub"](FR, even, odd)], dim=-2)
        a = a.reshape(*batch, n, ff.W)
    return a


def _launch_fft(a: torch.Tensor, k: int, tw: torch.Tensor) -> torch.Tensor:
    kernels.check_cuda_tensor("ntt input", a, torch.int32, ff.W)
    n = 1 << k
    batch = a.numel() // (n * ff.W)
    out = torch.empty_like(a)
    if batch == 0:
        return out
    kernels.launch("ntt", "ntt", "zk_ntt_bitrev", out.data_ptr(), a.data_ptr(), k, batch)
    logt = min(k, SHARED_LOG)
    kernels.launch("ntt", "ntt", "zk_ntt_shared", out.data_ptr(), tw.data_ptr(), k, logt, batch)
    for s in range(logt + 1, k + 1):
        kernels.launch("ntt", "ntt", "zk_ntt_stage", out.data_ptr(), tw.data_ptr(), k, s, batch)
    return out


def fft_core(a: torch.Tensor, k: int, inverse: bool) -> torch.Tensor:
    """In-order -> in-order radix-2 DIT NTT over dim -2 of (..., n, 8)."""
    n = 1 << k
    if a.shape[-2] != n:
        raise ValueError(f"ntt: expected {n} rows, got shape {tuple(a.shape)}")
    if n == 1:
        return a.clone()
    tw = _omega_powers(k, inverse, str(a.device))
    if a.device.type == "cpu":
        return _plain_fft(a, k, tw)
    return _launch_fft(a.contiguous(), k, tw)


def _log2(a: torch.Tensor) -> int:
    return int(a.shape[-2]).bit_length() - 1


def ntt(a: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """Coefficients -> evaluations on the 2^k domain (natural order)."""
    return fft_core(a, _log2(a) if k is None else k, inverse=False)


def intt(a: torch.Tensor, k: int | None = None) -> torch.Tensor:
    """Evaluations -> coefficients (includes the 1/n scaling)."""
    k = _log2(a) if k is None else k
    out = fft_core(a, k, inverse=True)
    return ff.mont_mul(FR, out, FR.const(pow(1 << k, FR_MOD - 2, FR_MOD), a.device))


def scale_by_powers(a: torch.Tensor, base: int) -> torch.Tensor:
    """a[..., i, :] *= base^i -- the coset-shift step of a coset FFT."""
    return ff.mont_mul(FR, a, power_table(base, a.shape[-2], a.device))


def coset_ntt(a: torch.Tensor, shift: int) -> torch.Tensor:
    """Evaluate the polynomial on the coset shift * <omega>."""
    return ntt(scale_by_powers(a, shift))


def coset_intt(a: torch.Tensor, shift: int) -> torch.Tensor:
    """Inverse of :func:`coset_ntt`."""
    return scale_by_powers(intt(a), pow(shift, FR_MOD - 2, FR_MOD))


PLAIN = {"fft": _plain_fft}
