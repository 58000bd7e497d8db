"""Bucketed (Pippenger) variable-base MSM with private buckets per lane
(kernel G and its plain version).

Port of ``zkevm_tpu/ec/pippenger.py`` (``signed_digits``, ``msm_t``,
``PippengerMSMT``), on the port's ``(N, 3, 8)`` Jacobian points and
``(N, 8)`` standard-form scalars. Same parameters and semantics: c-bit
windows, W = ceil(num_bits / c) of them (one more, the top carry, with
signed digits), Lw = min(sublanes, N) halved until it divides N, point i on
lane ``i % Lw`` at step ``i // Lw``, 2^c private buckets per (window, lane)
(2^(c-1) + 1 with signed digits), bucket 0 never folded. Then a lane merge,
the fold sum_b b * S_b per window, and Horner over the windows.

The kernels work on an affine copy of the points (``group.to_affine``),
which :class:`PippengerMSM` makes once. On CUDA tensors, for c <= LANE_MAX_C
:func:`msm` launches ``csrc/pippenger.cu`` (digits, the accumulation, which
sums each (lane, window)'s buckets one at a time in registers, one launch
per lane-merge level); wider windows, whose private buckets would fill
device memory (2^16 points per lane and window at the mesh engine's
c = 16), run G's digits through kernel C's sorted accumulation instead
(``ec/msm.py``: per window, the same sum of every point whose digit is b,
without lanes). Both end with C's fold and warp
Horner. On CPU tensors the plain version below adds in the same order, so
the two give the same Jacobian words: PyTorch for the accumulation (the
lanes, or C's sorted levels) and the fold, host integers for Horner. Only
affine results are comparable with the reference's, whose lane merge adds
in another order.
"""

from __future__ import annotations

import torch

from zkevm_tpu_torch import kernels
from zkevm_tpu_torch.ec import group, msm as msmmod
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FQ

MAX_C = 16
LANE_MAX_C = 4  # widest window of the private-bucket kernels (csrc/pippenger.cu)


def num_windows(c: int, num_bits: int = 256) -> int:
    return (num_bits + c - 1) // c


def num_buckets(c: int, signed: bool) -> int:
    return (1 << (c - 1)) + 1 if signed else 1 << c


def lane_width(n: int, sublanes: int) -> int:
    """The reference's Lw: min(sublanes, n), halved until it divides n."""
    lw = min(sublanes, n)
    while n % lw:
        lw //= 2
    return lw


def scalar_window(scalars: torch.Tensor, w: int, c: int) -> torch.Tensor:
    """Bits [w*c, w*c + c) of (N, 8) standard-form words -> (N,) int64."""
    words = scalars.to(torch.int64) & ff.MASK32
    word, off = divmod(w * c, 32)
    v = words[:, word] >> off
    if off + c > 32 and word + 1 < ff.W:
        v = v | (words[:, word + 1] << (32 - off))
    return v & ((1 << c) - 1)


def signed_digits(scalars: torch.Tensor, c: int, num_bits: int = 256):
    """Standard windows -> signed digits in [-(2^(c-1)), 2^(c-1)].

    Returns (mags, signs): (W+1, N) int32 magnitudes in [0, 2^(c-1)] and
    sign flags (1 = subtract the point); the last row is the top carry."""
    half, full = 1 << (c - 1), 1 << c
    mags, signs = [], []
    carry = torch.zeros(scalars.shape[0], dtype=torch.int64, device=scalars.device)
    for w in range(num_windows(c, num_bits)):
        d = scalar_window(scalars, w, c) + carry
        neg = d > half
        carry = neg.to(torch.int64)
        mags.append(torch.where(neg, full - d, d))
        signs.append(carry)
    mags.append(carry)
    signs.append(torch.zeros_like(carry))
    return torch.stack(mags).to(torch.int32), torch.stack(signs).to(torch.int32)


def digit_table(scalars: torch.Tensor, c: int, num_bits: int, signed: bool) -> torch.Tensor:
    """(N, WD) int64 digits, negative for a subtracted point (the layout
    kernel G's digit pass writes)."""
    if signed:
        mags, signs = signed_digits(scalars, c, num_bits)
        return torch.where(signs.bool(), -mags, mags).T.to(torch.int64)
    return torch.stack([scalar_window(scalars, w, c) for w in range(num_windows(c, num_bits))]).T


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _plain_lanes(affine: torch.Tensor, digits: torch.Tensor, lw: int, nb: int) -> torch.Tensor:
    """Every lane's private buckets in step order (mixed additions, as the
    accumulation kernel), then the lane merge as a halving tree padded with
    identities -> (WD, nb, 3, 8), bucket 0 the identity."""
    n, wd = digits.shape
    dev = affine.device
    buckets = group.identity((lw * wd, nb), dev)  # thread t = l * wd + w
    lanes = torch.arange(lw * wd, device=dev)
    for s in range(n // lw):
        d = digits[s * lw : (s + 1) * lw].reshape(-1)
        pts = affine[s * lw : (s + 1) * lw].repeat_interleave(wd, dim=0)
        if bool((d < 0).any()):
            neg_y = ff.PLAIN["sub"](FQ, torch.zeros_like(pts[:, 1]), pts[:, 1])
            pts[:, 1] = torch.where((d < 0)[:, None], neg_y, pts[:, 1])
        act = d != 0
        t, b = lanes[act], d[act].abs()
        buckets[t, b] = msmmod.madd_sparse(buckets[t, b], pts[act])
    a = buckets.reshape(lw, wd, nb, 3, ff.W)
    m = lw
    while m > 1:
        half = 1 << ((m - 1).bit_length() - 1)
        tail = a[half:m]
        if tail.shape[0] < half:
            pad = group.identity((half - tail.shape[0],) + tuple(a.shape[1:3]), dev)
            tail = torch.cat([tail, pad])
        a, m = msmmod.add_sparse(a[:half], tail), half
    return a[0]


def _plain_msm_affine(affine: torch.Tensor, scalars: torch.Tensor, c: int = 4, num_bits: int = 256,
                      sublanes: int = 1024, signed: bool = False) -> torch.Tensor:
    n = affine.shape[0]
    digits = digit_table(scalars, c, num_bits, signed)
    nb = num_buckets(c, signed)
    if c <= LANE_MAX_C:
        buckets = _plain_lanes(affine, digits, lane_width(n, sublanes), nb)
    else:
        buckets = msmmod.plain_sorted_buckets(affine, digits.T, nb)
    return msmmod.plain_horner(msmmod.plain_fold(buckets), c)


def _plain_msm(points: torch.Tensor, scalars: torch.Tensor, c: int = 4, num_bits: int = 256,
               sublanes: int = 1024, signed: bool = False) -> torch.Tensor:
    return _plain_msm_affine(group.PLAIN["to_affine"](points), scalars, c, num_bits, sublanes, signed)


# ---------------------------------------------------------------------------
# Kernel G
# ---------------------------------------------------------------------------

def _launch_msm(affine: torch.Tensor, scalars: torch.Tensor, c: int, num_bits: int, sublanes: int,
                signed: bool, marks: list | None = None) -> torch.Tensor:
    n = affine.shape[0]
    dev = affine.device
    windows = num_windows(c, num_bits)
    wd, nb = windows + int(signed), num_buckets(c, signed)
    digits = torch.empty(n, wd, dtype=torch.int32, device=dev)
    kernels.launch("pippenger", "pippenger", "zk_pip_digits", digits.data_ptr(), scalars.data_ptr(),
                   n, c, windows, int(signed))
    msmmod._mark(marks, "digits")
    if c <= LANE_MAX_C:
        lw = lane_width(n, sublanes)
        cur = torch.empty(lw * wd, nb, 3, ff.W, dtype=torch.int32, device=dev)
        row_len = -(-(n // lw + 3 * (nb - 1)) // 4) * 4  # each bucket's steps start on a multiple of 4
        order = torch.empty(lw * wd * row_len, dtype=torch.int32, device=dev)
        kernels.launch("pippenger", "pippenger", "zk_pip_accumulate", cur.data_ptr(), affine.data_ptr(),
                       digits.data_ptr(), order.data_ptr(), row_len, n // lw, lw, wd, nb)
        del digits, order
        msmmod._mark(marks, "accumulate")
        m = lw
        while m > 1:
            half = 1 << ((m - 1).bit_length() - 1)
            out = torch.empty(half * wd, nb, 3, ff.W, dtype=torch.int32, device=dev)
            kernels.launch("pippenger", "pippenger", "zk_pip_lane_halve", out.data_ptr(), cur.data_ptr(),
                           m, half, wd, nb)
            cur, m = out, half
        msmmod._mark(marks, "lane_merge")
    else:
        sd, perm = msmmod.sort_digits(digits.T.contiguous(), signed)
        del digits
        msmmod._mark(marks, "sort")
        cur = msmmod.accumulate(affine, sd, perm, nb, "pippenger")
        del sd, perm
        msmmod._mark(marks, "accumulate")
    wsums = msmmod.fold(cur.reshape(wd, nb, 3, ff.W), "pippenger")
    del cur
    msmmod._mark(marks, "fold")
    out = msmmod.horner(wsums, c, "pippenger")
    msmmod._mark(marks, "horner")
    return out


def msm_affine(affine: torch.Tensor, scalars: torch.Tensor, c: int = 4, num_bits: int = 256,
               sublanes: int = 1024, signed: bool = False, *, marks: list | None = None) -> torch.Tensor:
    """:func:`msm` over bases already converted by ``group.to_affine``
    ((N, 2, 8), the identity as (0, 0)); ``marks`` collects a CUDA event
    after each stage (chip_smoke.py times them)."""
    if affine.dim() != 3 or affine.shape[1:] != (2, ff.W) or affine.shape[0] == 0:
        raise ValueError(f"pippenger msm: affine bases must be (N, 2, 8), got {tuple(affine.shape)}")
    if scalars.shape != (affine.shape[0], ff.W):
        raise ValueError(f"pippenger msm: expected scalars {(affine.shape[0], ff.W)}, "
                         f"got {tuple(scalars.shape)}")
    if not 1 <= c <= MAX_C or not 1 <= num_bits <= 256 or sublanes < 1:
        raise ValueError(f"pippenger msm: need 1 <= c <= {MAX_C}, 1 <= num_bits <= 256, sublanes >= 1")
    if affine.device.type == "cpu" and scalars.device.type == "cpu":
        return _plain_msm_affine(affine, scalars, c, num_bits, sublanes, signed)
    affine, scalars = affine.contiguous(), scalars.contiguous()
    kernels.check_cuda_tensor("pippenger points", affine, torch.int32, ff.W)
    kernels.check_cuda_tensor("pippenger scalars", scalars, torch.int32, ff.W)
    return _launch_msm(affine, scalars, c, num_bits, sublanes, signed, marks)


def msm(points: torch.Tensor, scalars: torch.Tensor, c: int = 4, num_bits: int = 256,
        sublanes: int = 1024, signed: bool = False) -> torch.Tensor:
    """sum_i scalars[i] * points[i] -> one (3, 8) Jacobian point.

    points: (N, 3, 8) Jacobian (identity rows allowed), converted to affine
    on each call; scalars: (N, 8) standard-form (not Montgomery) words, any
    256-bit value."""
    if points.dim() != 3 or points.shape[1:] != (3, ff.W) or points.shape[0] == 0:
        raise ValueError(f"pippenger msm: points must be (N, 3, 8), got {tuple(points.shape)}")
    return msm_affine(group.to_affine(points), scalars, c, num_bits, sublanes, signed)


class PippengerMSM:
    """Commit engine over fixed bases (a loaded SRS): holds the (N, 3, 8)
    bases and their affine copy, made once, and maps (N, 8) standard-form
    scalars to one (3, 8) point."""

    def __init__(self, points: torch.Tensor, c: int = 4, sublanes: int = 1024):
        if points.dim() != 3 or points.shape[1:] != (3, ff.W):
            raise ValueError(f"PippengerMSM bases must be (N, 3, 8), got {tuple(points.shape)}")
        self.points = points.contiguous()
        self.affine = group.to_affine(self.points)
        self.c = c
        self.sublanes = sublanes
        self.n = points.shape[0]

    def __call__(self, scalars: torch.Tensor) -> torch.Tensor:
        return msm_affine(self.affine, scalars, c=self.c, sublanes=self.sublanes)


PLAIN = {"msm": _plain_msm}
