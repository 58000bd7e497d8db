"""Multi-scalar multiplication (kernel C's bucket MSM and its plain version).

One engine serves every size: the reference picks a windowed fixed-base MSM
for k <= 10 (``ec/msm.py``) and the sorted prefix-sum MSM for k > 10
(``ec/psmsm.py``); only affine results must match. On CUDA it is the bucket
method of ``csrc/curve.cu`` over an affine copy of the bases made once
(``group.to_affine``): digits, ``torch.sort`` of (digit, index) pairs per
window, a balanced segmented bucket accumulation with mixed additions, the
fold sum_b b * S_b in levels of short segments, and Horner in one warp. On
the CPU the plain version selects from a table of 2^j * P_i and sums with a
halving tree; the table is built once per base set.

The kernel's stages after the sort are also the wide-window path of kernel
G (``ec/pippenger.py``), whose plain version follows their order of
additions with :func:`plain_sorted_buckets`, :func:`plain_fold` and
:func:`plain_horner`.
"""

from __future__ import annotations

import torch

from zkevm_tpu_torch import kernels
from zkevm_tpu_torch.ec import group
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FQ

CHUNK = 32  # sorted points one thread adds on the accumulation's first level
CHUNK_NEXT = 8  # partial sums one thread adds on each later level (mostly runs of two)
FOLD_LOG = 3  # the fold's first level takes segments of 2^FOLD_LOG buckets, later levels pairs


def window_bits(n: int) -> int:
    """Window width c for n points: 16 at production sizes, smaller for
    small n so the bucket array stays proportionate."""
    return max(4, min(16, n.bit_length() - 4))


def _mark(marks, name: str) -> None:
    """Record a CUDA event after a stage when the caller collects them."""
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))


def sort_digits(digits: torch.Tensor, signed: bool = True):
    """(W, n) int32 digits below 2^16, negative for a negated base when
    ``signed`` -> (the magnitudes sorted per window, stably, as int32; the
    int32 perm, ~index for a negated base). The keys are sorted as 16-bit
    integers (magnitude - 2^15), which takes half the radix passes of 32-bit
    keys and gives the same order."""
    mags = digits.abs() if signed else digits
    keys, perm = torch.sort((mags - (1 << 15)).to(torch.int16), dim=1, stable=True)
    perm = perm.to(torch.int32)
    if signed:
        neg = torch.gather(digits < 0, 1, perm.long())
        if bool(neg.any()):
            perm = torch.where(neg, ~perm, perm)
    return (keys.to(torch.int32) + (1 << 15)).contiguous(), perm.contiguous()


def accumulate(affine: torch.Tensor, sd: torch.Tensor, perm: torch.Tensor, nb: int, kernel: str
               ) -> torch.Tensor:
    """Bucket sums (W, nb, 3, 8) of the sorted digits ``sd`` (W, n) and
    their bases ``affine[perm]`` by curve.cu's segmented accumulation, one
    launch per level; the launches count towards ``kernel``."""
    windows, n = sd.shape
    dev = sd.device
    buckets = group.identity((windows, nb), dev)
    pts, digits, length, first = None, sd, n, True
    while True:
        ch = CHUNK if first else CHUNK_NEXT
        final = length <= ch
        nchunks = -(-length // ch)
        out_pts = torch.empty(windows, 2 * nchunks, 3, ff.W, dtype=torch.int32, device=dev)
        out_digits = torch.empty(windows, 2 * nchunks, dtype=torch.int32, device=dev)
        kernels.launch(
            kernel, "curve", "zk_msm_accumulate",
            affine.data_ptr() if first else 0,
            perm.data_ptr() if first else 0,
            0 if first else pts.data_ptr(),
            digits.data_ptr(), out_pts.data_ptr(), out_digits.data_ptr(), buckets.data_ptr(),
            length, nb, windows, ch, int(final),
        )
        if final:
            return buckets
        pts, digits, length, first = out_pts, out_digits, 2 * nchunks, False


def fold_levels(m: int) -> list[tuple[int, int]]:
    """(segments per window, log2 of the segment length) on each level of
    the fold of m items: segments of 2^FOLD_LOG on the first level, whose
    threads are many, then pairs, so that each later level's chain is two
    additions long; down to the last level's one segment."""
    levels = [(-(-m // (1 << FOLD_LOG)), FOLD_LOG)]
    while levels[-1][0] > 1:
        levels.append((-(-levels[-1][0] // 2), 1))
    return levels


def fold(buckets: torch.Tensor, kernel: str) -> torch.Tensor:
    """(W, m, 3, 8) buckets -> (W, 3, 8) window sums sum_b b * S_b by
    curve.cu's fold, one launch per level of 2^FOLD_LOG-item segments."""
    windows, m = buckets.shape[:2]
    dev = buckets.device
    cur, has_y = buckets.contiguous(), 0
    for parts, log_l in fold_levels(m):
        final = parts == 1
        shape = (windows, 3, ff.W) if final else (windows, parts, 2, 3, ff.W)
        out = torch.empty(shape, dtype=torch.int32, device=dev)
        kernels.launch(kernel, "curve", "zk_msm_fold", out.data_ptr(), cur.data_ptr(), windows, m,
                       log_l, has_y, int(final))
        cur, m, has_y = out, parts, 1
    return cur


def horner(wsums: torch.Tensor, c: int, kernel: str) -> torch.Tensor:
    """sum_w 2^(c w) wsums[w] -> one (3, 8) point (curve.cu's warp Horner)."""
    out = torch.empty(3, ff.W, dtype=torch.int32, device=wsums.device)
    kernels.launch(kernel, "curve", "zk_g1_horner", out.data_ptr(), wsums.contiguous().data_ptr(),
                   wsums.shape[0], c)
    return out


def _launch_msm(affine: torch.Tensor, scalars: torch.Tensor, marks: list | None = None) -> torch.Tensor:
    n = affine.shape[0]
    dev = affine.device
    c = window_bits(n)
    windows = -(-256 // c)
    digits = torch.empty(windows, n, dtype=torch.int32, device=dev)
    kernels.launch("msm", "curve", "zk_msm_digits", digits.data_ptr(), scalars.data_ptr(), n, c,
                   windows)
    _mark(marks, "digits")
    sd, perm = sort_digits(digits, signed=False)
    del digits
    _mark(marks, "sort")
    buckets = accumulate(affine, sd, perm, 1 << c, "msm")
    del sd, perm
    _mark(marks, "accumulate")
    wsums = fold(buckets, "msm")
    del buckets
    _mark(marks, "fold")
    out = horner(wsums, c, "msm")
    _mark(marks, "horner")
    return out


class MSM:
    """Commitment engine over a fixed base set (the SRS).

    bases: (N, 3, 8) Jacobian points; calls take (N, 8) standard-form
    scalars and return one (3, 8) point. On CUDA the engine keeps the
    bases' affine copy ``affine`` (N, 2, 8), made once here."""

    def __init__(self, bases: torch.Tensor):
        if bases.dim() != 3 or bases.shape[1:] != (3, ff.W):
            raise ValueError(f"MSM bases must be (N, 3, 8), got {tuple(bases.shape)}")
        self.bases = bases.contiguous()
        self.affine = None if self.bases.device.type == "cpu" else group.to_affine(self.bases)
        self._table = None

    def plain_table(self) -> torch.Tensor:
        if self._table is None:
            self._table = group.doubling_table(self.bases)
        return self._table

    def __call__(self, scalars: torch.Tensor, *, marks: list | None = None) -> torch.Tensor:
        """sum_i scalars[i] * bases[i]. ``marks`` collects a CUDA event
        after each stage, for timing the kernel by stage (chip_smoke.py)."""
        if scalars.shape != (self.bases.shape[0], ff.W):
            raise ValueError(f"MSM: expected scalars {(self.bases.shape[0], ff.W)}, "
                             f"got {tuple(scalars.shape)}")
        if self.bases.device.type == "cpu" and scalars.device.type == "cpu":
            return plain_msm(self.bases, scalars, self.plain_table())
        scalars = scalars.contiguous()
        kernels.check_cuda_tensor("msm bases", self.bases, torch.int32, ff.W)
        kernels.check_cuda_tensor("msm scalars", scalars, torch.int32, ff.W)
        return _launch_msm(self.affine, scalars, marks)


def plain_msm(bases: torch.Tensor, scalars: torch.Tensor, table: torch.Tensor | None = None):
    """sum_i k_i P_i by plain PyTorch: per-lane bit selection from the
    doubling table, then one halving tree over all (bit, lane) terms."""
    if table is None:
        table = group.doubling_table(bases)
    bits = group.scalar_bits(scalars).T.bool()  # (256, N)
    terms = table[bits]  # only the set bits
    if terms.shape[0] == 0:
        return group.identity((), bases.device)
    return group.PLAIN["sum"](terms)


def msm(bases: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Variable-base MSM: sum_i scalars[i] * bases[i]."""
    return MSM(bases)(scalars)


# ---------------------------------------------------------------------------
# The kernel's order of additions in plain PyTorch (kernel G's wide-window
# path holds its words to these)
# ---------------------------------------------------------------------------

def add_sparse(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The plain complete addition, computing formulas only where neither
    operand is the identity (the same words as ``group.PLAIN["add"]``)."""
    p_inf = ff.is_zero(p[..., 2, :])
    q_inf = ff.is_zero(q[..., 2, :])
    out = torch.where(p_inf[..., None, None], q, p)
    both = ~p_inf & ~q_inf
    if bool(both.any()):
        out[both] = group.PLAIN["add"](p[both], q[both])
    return out


def madd_sparse(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``group.PLAIN["madd"]`` of Jacobian p and affine q, its formulas
    computed only where p is not the identity and q is not the sentinel."""
    base_inf = ff.is_zero(q[..., 0, :]) & ff.is_zero(q[..., 1, :])
    p_inf = ff.is_zero(p[..., 2, :]) & ~base_inf
    out = p.clone()
    if bool(p_inf.any()):
        out[p_inf] = torch.cat([q[p_inf], FQ.mont_one(p.device).expand(int(p_inf.sum()), 1, ff.W)], dim=1)
    both = ~p_inf & ~base_inf & ~ff.is_zero(p[..., 2, :])
    if bool(both.any()):
        out[both] = group.PLAIN["madd"](p[both], q[both])
    return out


def double_sparse(p: torch.Tensor) -> torch.Tensor:
    """The plain doubling, the identity left as it is (curve.cuh's pt_double)."""
    live = ~ff.is_zero(p[..., 2, :])
    out = p.clone()
    if bool(live.any()):
        out[live] = group.PLAIN["double"](p[live])
    return out


def _plain_level(items, digits, buckets, affine_level: bool):
    """One level of the segmented accumulation, as the kernel runs it on
    every chunk of CHUNK (first level) or CHUNK_NEXT sorted items: a left
    fold per run of equal digits,
    runs inside a chunk (and every run on the final level) to their bucket,
    a chunk's first and last run to the next level's slots 2c and 2c + 1."""
    windows, length = digits.shape
    dev = digits.device
    ch = CHUNK if affine_level else CHUNK_NEXT
    nc = -(-length // ch)
    final = length <= ch
    padded = torch.cat([digits.to(torch.int64), digits.new_full((windows, nc * ch - length), -1)
                        .to(torch.int64)], dim=1).reshape(windows, nc, ch)
    w_idx = torch.arange(windows, device=dev)[:, None].expand(windows, nc)
    c_idx = torch.arange(nc, device=dev)[None, :].expand(windows, nc)
    acc = group.identity((windows, nc), dev)
    first = torch.ones(windows, nc, dtype=torch.bool, device=dev)
    cur = padded[:, :, 0].clone()
    out = group.identity((windows, 2 * nc), dev)
    out_d = torch.zeros(windows, 2 * nc, dtype=torch.int32, device=dev)

    def emit(mask, last: bool):
        if final or not last:
            to_bucket = mask & ((~first) if not final else torch.ones_like(first)) & (cur != 0)
            buckets[w_idx[to_bucket], cur[to_bucket]] = acc[to_bucket]
        if final:
            return
        slot_mask = mask & first if not last else mask
        slot = 2 * c_idx + (0 if not last else (~first).to(torch.int64))
        out[w_idx[slot_mask], slot[slot_mask]] = acc[slot_mask]
        out_d[w_idx[slot_mask], slot[slot_mask]] = cur[slot_mask].to(torch.int32)
        if last:
            both = mask & first
            out[w_idx[both], slot[both] + 1] = group.identity((), dev)
            out_d[w_idx[both], slot[both] + 1] = cur[both].to(torch.int32)

    for e in range(ch):
        d = padded[:, :, e]
        valid = d >= 0
        change = valid & (d != cur)
        emit(change, False)
        first = first & ~change
        acc = torch.where(change[..., None, None], group.identity((), dev), acc)
        cur = torch.where(change, d, cur)
        act = valid & (d != 0)
        if bool(act.any()):
            pos = c_idx[act] * ch + e
            item = items[w_idx[act], pos]
            acc[act] = madd_sparse(acc[act], item) if affine_level else add_sparse(acc[act], item)
    emit(torch.ones_like(first), True)
    return None if final else (out, out_d)


def plain_sorted_buckets(affine: torch.Tensor, digits: torch.Tensor, nb: int) -> torch.Tensor:
    """Bucket sums (W, nb, 3, 8) of (W, n) digits (negative: the base
    negated) over (n, 2, 8) affine bases, with the kernel's words: sorted
    as :func:`sort_digits` sorts, then accumulated level by level as
    curve.cu's ``msm_accumulate_kernel`` adds."""
    windows = digits.shape[0]
    sd, perm = sort_digits(digits.to(torch.int32))
    neg = perm < 0
    idx = torch.where(neg, ~perm, perm).long()
    items = affine[idx]  # (W, n, 2, 8)
    neg_y = ff.PLAIN["sub"](FQ, torch.zeros_like(items[..., 1, :]), items[..., 1, :])
    items[..., 1, :] = torch.where(neg[..., None], neg_y, items[..., 1, :])
    buckets = group.identity((windows, nb), affine.device)
    level, affine_level = (items, sd), True
    while level is not None:
        level = _plain_level(level[0], level[1], buckets, affine_level)
        affine_level = False
    return buckets


def plain_fold(buckets: torch.Tensor) -> torch.Tensor:
    """(W, m, 3, 8) -> (W, 3, 8) window sums sum_b b * S_b in the order of
    curve.cu's ``msm_fold_kernel``, level by level."""
    x, y = buckets, None
    dev = buckets.device
    for parts, log_l in fold_levels(buckets.shape[1]):
        seg = 1 << log_l
        windows, m = x.shape[:2]
        pad = parts * seg - m
        if pad:
            x = torch.cat([x, group.identity((windows, pad), dev)], dim=1)
            if y is not None:
                y = torch.cat([y, group.identity((windows, pad), dev)], dim=1)
        x = x.reshape(windows, parts, seg, 3, ff.W)
        if y is not None:
            y = y.reshape(windows, parts, seg, 3, ff.W)
        j = torch.arange(parts, device=dev)[None, :].expand(windows, parts)
        suffix = group.identity((windows, parts), dev)
        total = group.identity((windows, parts), dev)
        for r in range(seg - 1, -1, -1):
            b = j * seg + r
            rd = (b > 0) & (b < m)
            if bool(rd.any()):
                suffix[rd] = add_sparse(suffix[rd], x[:, :, r][rd])
            if r > 0:
                total = add_sparse(total, suffix)
        if y is not None:
            for r in range(seg):
                rd = j * seg + r < m
                total[rd] = add_sparse(total[rd], y[:, :, r][rd])
        if parts == 1:
            return total[:, 0]
        for _ in range(log_l):
            suffix = double_sparse(suffix)
        x, y = suffix, total


_Q = FQ.modulus
_RINV = pow(1 << 256, -1, _Q)
_IDENTITY = (FQ.r, FQ.r, 0)


def _mm(a: int, b: int) -> int:
    return a * b * _RINV % _Q


def _host_double(p):
    """dbl-2009-l on Montgomery ints, as curve.cuh's pt_double (the
    identity left as it is)."""
    x, y, z = p
    if z == 0:
        return p
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


def plain_horner(wsums: torch.Tensor, c: int) -> torch.Tensor:
    """sum_w 2^(c w) wsums[w] with the warp Horner's words: its formulas on
    host integers, a chain over a few points where torch's per-call cost
    would dominate."""
    v = ff.ints_from_words(wsums)
    pts = [tuple(v[i : i + 3]) for i in range(0, len(v), 3)]
    acc = _IDENTITY
    for w in range(len(pts) - 1, -1, -1):
        for _ in range(c):
            acc = _host_double(acc)
        acc = _host_add(acc, pts[w])
    return ff.to_tensor(ff.words_from_ints(acc), wsums.device)
