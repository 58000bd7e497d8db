"""Bucketed (Pippenger) variable-base MSM with private buckets and no sort
(kernel G and its plain version).

Port of ``zkevm_tpu/ec/pippenger.py`` (``signed_digits``, ``msm_t``,
``PippengerMSMT``), on the port's ``(N, 3, 8)`` Jacobian points and
``(N, 8)`` standard-form scalars. Same parameters and semantics: c-bit
windows, W = ceil(num_bits / c) of them (one more, the top carry, with
signed digits), Lw = min(sublanes, N) halved until it divides N, point i on
lane ``i % Lw`` at step ``i // Lw``, 2^c private buckets per (window, lane)
(2^(c-1) + 1 with signed digits), bucket 0 never folded. Then a lane merge,
the fold sum_b b * S_b per window, and Horner over the windows.

On CUDA tensors :func:`msm` launches ``csrc/pippenger.cu`` (digits,
accumulate, one launch per lane-merge level, the fold's segments and their
combination) and curve.cu's Horner.
On CPU tensors the plain version below adds in the same order, so the two
give the same Jacobian words: PyTorch for the accumulation and the lane
merge (a halving tree where the reference scans), and host integers with
the kernel's formulas for the fold and Horner, a chain over a few points
where torch's per-call cost would dominate. Only affine results are
comparable with the reference's, whose lane merge adds in another order.
"""

from __future__ import annotations

import torch

from zkevm_tpu_torch import kernels
from zkevm_tpu_torch.ec import group
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FQ

MAX_C = 16
FOLD_SEGMENT = 256  # buckets one thread of the fold sums (fewer when a window has fewer)


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


def fold_segments(nb: int) -> tuple[int, int]:
    """(P, L): the fold's P segments of L buckets (L a power of two, P * L
    >= nb) of a window of nb buckets."""
    seg = min(FOLD_SEGMENT, 1 << (nb - 1).bit_length())
    return -(-nb // seg), seg


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

def _add_sparse(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The plain complete addition, computing formulas only where neither
    operand is the identity (the same words as ``group.PLAIN["add"]``)."""
    p_inf = ff.is_zero(p[..., 2, :])
    q_inf = ff.is_zero(q[..., 2, :])
    out = torch.where(p_inf[..., None, None], q, p)
    both = ~p_inf & ~q_inf
    if bool(both.any()):
        out[both] = group.PLAIN["add"](p[both], q[both])
    return out


_Q = FQ.modulus
_ONE = FQ.r
_RINV = pow(1 << 256, -1, _Q)
_IDENTITY = (_ONE, _ONE, 0)


def _mm(a: int, b: int) -> int:
    return a * b * _RINV % _Q


def _host_double(p):
    """dbl-2009-l on Montgomery ints, as curve.cuh's pt_double."""
    x, y, z = p
    a, b = _mm(x, x), _mm(y, y)
    c = _mm(b, b)
    d = 2 * ((_mm(x + b, x + b) - a - c) % _Q) % _Q
    e = 3 * a % _Q
    x3 = (_mm(e, e) - 2 * d) % _Q
    return x3, (_mm(e, d - x3) - 8 * c) % _Q, 2 * _mm(y, z) % _Q


def _host_add(p, q):
    """Complete add-2007-bl on Montgomery ints, as curve.cuh's pt_add."""
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    (x1, y1, z1), (x2, y2, z2) = p, q
    z1z1, z2z2 = _mm(z1, z1), _mm(z2, z2)
    u1, u2 = _mm(x1, z2z2), _mm(x2, z1z1)
    s1, s2 = _mm(_mm(y1, z2), z2z2), _mm(_mm(y2, z1), z1z1)
    h = (u2 - u1) % _Q
    r = 2 * (s2 - s1) % _Q
    if h == 0:
        return _host_double(p) if r == 0 else _IDENTITY
    i = _mm(2 * h, 2 * h)
    j, v = _mm(h, i), _mm(u1, i)
    x3 = (_mm(r, r) - j - 2 * v) % _Q
    y3 = (_mm(r, v - x3) - 2 * _mm(s1, j)) % _Q
    return x3, y3, _mm(_mm(z1 + z2, z1 + z2) - z1z1 - z2z2, h)


def _host_points(p: torch.Tensor) -> list:
    """(..., 3, 8) -> list of (x, y, z) Montgomery int triples."""
    v = ff.ints_from_words(p)
    return [tuple(v[i : i + 3]) for i in range(0, len(v), 3)]


def _plain_msm(points: torch.Tensor, scalars: torch.Tensor, c: int = 4, num_bits: int = 256,
               sublanes: int = 1024, signed: bool = False) -> torch.Tensor:
    n = points.shape[0]
    lw = lane_width(n, sublanes)
    digits = digit_table(scalars, c, num_bits, signed)
    wd, nb = digits.shape[1], num_buckets(c, signed)
    dev = points.device
    # accumulate: lane t = l * wd + w holds buckets 1..nb-1 (index 0 unused)
    buckets = group.identity((lw * wd, nb), dev)
    lanes = torch.arange(lw * wd, device=dev)
    for s in range(n // lw):
        d = digits[s * lw : (s + 1) * lw].reshape(-1)
        pts = points[s * lw : (s + 1) * lw].repeat_interleave(wd, dim=0)
        if signed:
            neg_y = ff.PLAIN["sub"](FQ, torch.zeros_like(pts[:, 1]), pts[:, 1])
            pts = pts.clone()
            pts[:, 1] = torch.where((d < 0)[:, None], neg_y, pts[:, 1])
        act = d != 0
        t, b = lanes[act], d[act].abs()
        buckets[t, b] = _add_sparse(buckets[t, b], pts[act])
    # lane merge: a halving tree, the lane count padded with identities
    a = buckets.reshape(lw, wd, nb, 3, ff.W)[:, :, 1:]
    m = lw
    while m > 1:
        half = 1 << ((m - 1).bit_length() - 1)
        tail = a[half:m]
        if tail.shape[0] < half:
            pad = group.identity((half - tail.shape[0],) + tuple(a.shape[1:3]), dev)
            tail = torch.cat([tail, pad])
        a, m = _add_sparse(a[:half], tail), half
    merged = _host_points(a[0])  # (wd, nb - 1), bucket b at b - 1
    # fold sum_b b * S_b by segments, and Horner, in the kernels' order
    parts, seg = fold_segments(nb)
    acc = _IDENTITY
    wsums = []
    for w in range(wd):
        sums, totals = [], []
        for j in range(parts):
            suffix = total = _IDENTITY
            for b in range((j + 1) * seg - 1, j * seg - 1, -1):
                if 0 < b < nb:
                    suffix = _host_add(suffix, merged[w * (nb - 1) + b - 1])
                if b > j * seg:
                    total = _host_add(total, suffix)
            sums.append(suffix)
            totals.append(total)
        u = t = r = _IDENTITY
        for j in range(parts - 1, -1, -1):
            u = _host_add(u, sums[j])
            if j:
                t = _host_add(t, u)
            r = _host_add(r, totals[j])
        for _ in range(seg.bit_length() - 1):
            t = _host_double(t)
        wsums.append(_host_add(r, t))
    for w in range(wd - 1, -1, -1):
        for _ in range(c):
            acc = _host_double(acc)
        acc = _host_add(acc, wsums[w])
    return ff.to_tensor(ff.words_from_ints(acc), dev)


# ---------------------------------------------------------------------------
# Kernel G
# ---------------------------------------------------------------------------

def _launch_msm(points: torch.Tensor, scalars: torch.Tensor, c: int, num_bits: int, sublanes: int,
                signed: bool) -> torch.Tensor:
    n = points.shape[0]
    dev = points.device
    lw = lane_width(n, sublanes)
    windows = num_windows(c, num_bits)
    wd, nb = windows + int(signed), num_buckets(c, signed)
    digits = torch.empty(n, wd, dtype=torch.int32, device=dev)
    kernels.launch("pippenger", "pippenger", "zk_pip_digits", digits.data_ptr(), scalars.data_ptr(),
                   n, c, windows, int(signed))
    cur = torch.empty(lw * wd, nb, 3, ff.W, dtype=torch.int32, device=dev)
    kernels.launch("pippenger", "pippenger", "zk_pip_accumulate", cur.data_ptr(), points.data_ptr(),
                   digits.data_ptr(), n // lw, lw, wd, nb)
    del digits
    m = lw
    while m > 1:
        half = 1 << ((m - 1).bit_length() - 1)
        out = torch.empty(half * wd, nb, 3, ff.W, dtype=torch.int32, device=dev)
        kernels.launch("pippenger", "pippenger", "zk_pip_lane_halve", out.data_ptr(), cur.data_ptr(),
                       m, half, wd, nb)
        cur, m = out, half
    parts, seg = fold_segments(nb)
    sums = torch.empty(wd, parts, 2, 3, ff.W, dtype=torch.int32, device=dev)
    kernels.launch("pippenger", "pippenger", "zk_pip_fold_segments", sums.data_ptr(), cur.data_ptr(), wd, nb,
                   parts, seg)
    del cur
    wsums = torch.empty(wd, 3, ff.W, dtype=torch.int32, device=dev)
    kernels.launch("pippenger", "pippenger", "zk_pip_fold_combine", wsums.data_ptr(), sums.data_ptr(), wd,
                   parts, seg.bit_length() - 1)
    out = torch.empty(3, ff.W, dtype=torch.int32, device=dev)
    kernels.launch("pippenger", "curve", "zk_g1_horner", out.data_ptr(), wsums.data_ptr(), wd, c)
    return out


def msm(points: torch.Tensor, scalars: torch.Tensor, c: int = 4, num_bits: int = 256,
        sublanes: int = 1024, signed: bool = False) -> torch.Tensor:
    """sum_i scalars[i] * points[i] -> one (3, 8) Jacobian point.

    points: (N, 3, 8) Jacobian (identity rows allowed); scalars: (N, 8)
    standard-form (not Montgomery) words, any 256-bit value."""
    if points.dim() != 3 or points.shape[1:] != (3, ff.W) or points.shape[0] == 0:
        raise ValueError(f"pippenger msm: points must be (N, 3, 8), got {tuple(points.shape)}")
    if scalars.shape != (points.shape[0], ff.W):
        raise ValueError(f"pippenger msm: expected scalars {(points.shape[0], ff.W)}, "
                         f"got {tuple(scalars.shape)}")
    if not 1 <= c <= MAX_C or not 1 <= num_bits <= 256 or sublanes < 1:
        raise ValueError(f"pippenger msm: need 1 <= c <= {MAX_C}, 1 <= num_bits <= 256, sublanes >= 1")
    if points.device.type == "cpu" and scalars.device.type == "cpu":
        return _plain_msm(points, scalars, c, num_bits, sublanes, signed)
    points, scalars = points.contiguous(), scalars.contiguous()
    kernels.check_cuda_tensor("pippenger points", points, torch.int32, ff.W)
    kernels.check_cuda_tensor("pippenger scalars", scalars, torch.int32, ff.W)
    return _launch_msm(points, scalars, c, num_bits, sublanes, signed)


class PippengerMSM:
    """Commit engine over fixed bases (a loaded SRS): holds the (N, 3, 8)
    bases and maps (N, 8) standard-form scalars to one (3, 8) point."""

    def __init__(self, points: torch.Tensor, c: int = 4, sublanes: int = 1024):
        if points.dim() != 3 or points.shape[1:] != (3, ff.W):
            raise ValueError(f"PippengerMSM bases must be (N, 3, 8), got {tuple(points.shape)}")
        self.points = points.contiguous()
        self.c = c
        self.sublanes = sublanes
        self.n = points.shape[0]

    def __call__(self, scalars: torch.Tensor) -> torch.Tensor:
        return msm(self.points, scalars, c=self.c, sublanes=self.sublanes)


PLAIN = {"msm": _plain_msm}
