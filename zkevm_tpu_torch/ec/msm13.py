"""Sort and prefix-scan MSM over the lazy-13 field (kernel L and its plain version).

Port of ``zkevm_tpu/ec/msm13.py``. Bases are affine points in lazy-13
coordinates (``(21, N)`` standard-form 13-bit limbs, ``ff/lazy13.py``);
accumulators are Jacobian ``G1L`` points with an explicit identity flag.
Per c-bit window (W = ceil(num_bits / c) of them) the points are sorted by
digit (a stable sort of (digit, index)); windows run in groups of
``wgroup``, their sorted leaves laid out (G, Lw, S) with Lw = min(lanes, N)
(halved until it divides N) and S = N / Lw. Each lane scans its S leaves
with mixed additions, keeping its prefix values; a two-level blocked
exclusive scan over the Lw lane totals gives each lane's offset and the
window total; the prefix sums at the B - 1 digit boundaries (B = 2^c) are
an offset plus a prefix value; a log-depth tree sums them, and G_w =
(B - 1) * Total - sum PS comes from c double-and-add steps. A Horner over
the windows (c doublings and one addition each) ends it.

The one departure from the reference: boundaries that no digit separates
hold equal prefix sums (every boundary past a window's largest digit holds
the window total, and 254-bit scalars leave the top window short of 2^c),
so the tree meets equal inputs on nearly every MSM. The reference raises
its doubling flag there and falls back; here the tree doubles. Every other
addition keeps the flag, which then means equal inputs that only a
discrete-log relation between the bases can give (equal bases with equal
scalars, say); ``Msm13`` then falls back to the Pippenger MSM G
(``ec/pippenger.py``, the reference's ``msm_t``) and counts it.

On CUDA tensors ``msm13`` launches kernel L (``csrc/msm13.cu``), each
stage once for all W windows (``wgroup`` bounds the plain version's memory
only): digits, the per-lane scan (one thread per (window, lane), reading
each leaf through the sorted permutation from the bases' point-major copy
``pack_bases``, which ``Msm13`` keeps), the lane offsets (``_lane_offsets``:
exclusive scans over groups of 8 lane totals level by level, and the
offsets back down), the boundary prefix sums, one launch per tree level,
the per-window (B - 1) * Total - sum PS, and the Horner; the sort is
``torch.sort`` on 16-bit keys. L keeps the plain version's order of
additions but in the lane offsets, where the reference runs two chains of
~sqrt(Lw) additions: so L's words equal those of the plain version run
with ``lane_radix=LANE_RADIX``, and differ from the reference's, whose
affine points and flags they give where no repeated base meets itself. L
stores a lane's prefix value only at the end of each digit's run (the only
ones the boundaries read; ``run_end_tags``), indexed by digit, and keeps
its points as 40-word records (``pack_points``). On CPU tensors the plain
version below runs the same steps on batches of int64 limbs, with the same
words and flags; its boundary stage and tree compute each distinct pair of
inputs once (at small N most of the 2^c boundaries repeat a prefix), which
changes no word. With
``complete=False`` its tree raises the flag as the reference's does, and
its words and flags are the reference's.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from zkevm_tpu_torch import kernels
from zkevm_tpu_torch.ec import group, pippenger as pip
from zkevm_tpu_torch.ec.msm import _mark, sort_digits
from zkevm_tpu_torch.ff import field as ff, lazy13 as lz
from zkevm_tpu_torch.ff.field import FQ
from zkevm_tpu_torch.ff.lazy13 import L13

LZ = lz.ctx_fq()
SCALES = (1, 2, 3, 4, -1, -2, -4, -8)  # csrc/lazy13.cuh l13::Scale, in order


class G1L(NamedTuple):
    """Jacobian points in lazy-13 coordinates with an identity flag."""
    x: torch.Tensor  # (21, ...)
    y: torch.Tensor
    z: torch.Tensor
    inf: torch.Tensor  # bool (...)

    @property
    def batch_shape(self):
        return tuple(self.x.shape[1:])


def identity_l(batch_shape, device, dtype=torch.int32) -> G1L:
    one = torch.zeros(L13, *batch_shape, dtype=dtype, device=device)
    one[0] = 1
    zero = torch.zeros(L13, *batch_shape, dtype=dtype, device=device)
    return G1L(one, one.clone(), zero, torch.ones(tuple(batch_shape), dtype=torch.bool, device=device))


def select_l(cond: torch.Tensor, p: G1L, q: G1L) -> G1L:
    return G1L(lz.select13(cond, p.x, q.x), lz.select13(cond, p.y, q.y), lz.select13(cond, p.z, q.z),
               torch.where(cond, p.inf, q.inf))


# ---------------------------------------------------------------------------
# Plain version: point formulas on int64 limbs, flags as bool tensors
# ---------------------------------------------------------------------------

# The plain formulas batch the independent products and reductions of each
# step into one call (operands side by side on the batch axis, reductions
# of different scales as one batched matrix product); every lane's words
# are those of the reference's sequence of single operations.

_T = lz._p_prod_T


def _R(terms):
    return lz._p_reduce(LZ, terms)


def _RR(*groups):
    return lz._p_reduce_many(LZ, list(groups))


def _sub(a, b):
    return lz._p_sub(LZ, a, b)


def _add(a, b):
    return lz._p_add(LZ, a, b)


def _mul(a, b):
    return _R([(_T(a, b), 1)])


def _c(*xs):
    return torch.cat(xs, dim=-1)


def _s(x, k):
    return x.chunk(k, dim=-1)


def _flat_pt(p: G1L) -> G1L:
    return G1L(*(lz._flat(c).to(torch.int64) for c in (p.x, p.y, p.z)), p.inf.reshape(-1))


def _p_madd_l(p: G1L, qx, qy):
    """madd-2007-bl on flat int64 batches: (result, same.any())."""
    x1, y1, z1 = p.x, p.y, p.z
    t1 = _T(_c(z1, qy), _c(z1, z1))  # z1^2, qy z1
    z1z1_T = _s(t1, 2)[0]
    z1z1, t = _s(_R([(t1, 1)]), 2)
    u2, s2 = _s(_mul(_c(qx, t), _c(z1z1, z1z1)), 2)
    h, rh = _s(_sub(_c(u2, s2), _c(x1, y1)), 2)
    hh_T = _T(h, h)
    hh = _R([(hh_T, 1)])
    t4 = _T(_c(h, x1), _c(hh, hh))  # h^3, x1 h^2
    hhh_T, v_T = _s(t4, 2)
    j, v = _s(_R([(t4, 4)]), 2)
    zh = _add(z1, h)
    rh2_T, zh2_T = _s(_T(_c(rh, zh), _c(rh, zh)), 2)
    x3, z3 = _RR([(rh2_T, 4), (hhh_T, -4), (v_T, -8)], [(zh2_T, 1), (z1z1_T, -1), (hh_T, -1)])
    ta, tb = _s(_T(_c(rh, y1), _c(_sub(v, x3), j)), 2)
    y3 = _R([(ta, 2), (tb, -2)])
    h_zero, r_zero = _s(lz._p_is_zero(LZ, _c(h, rh)), 2)
    same = h_zero & r_zero & ~p.inf
    opposite = h_zero & ~r_zero & ~p.inf
    one = torch.zeros_like(z3)
    one[0] = 1
    c = p.inf[None]
    return (G1L(torch.where(c, qx, x3), torch.where(c, qy, y3), torch.where(c, one, z3), opposite),
            same.any())


def _p_add_l(p: G1L, q: G1L, dbl: bool = False):
    """add-2007-bl, complete by flag selects: (result, same.any()). With
    ``dbl``, lanes whose inputs are equal take ``_p_double_l(p)`` and raise
    no flag."""
    x1, y1, z1 = p.x, p.y, p.z
    x2, y2, z2 = q.x, q.y, q.z
    t1 = _T(_c(z1, z2, y1, y2), _c(z1, z2, z2, z1))  # z1^2, z2^2, y1 z2, y2 z1
    z1z1_T, z2z2_T, _, _ = _s(t1, 4)
    z1z1, z2z2, y1z2, y2z1 = _s(_R([(t1, 1)]), 4)
    u1, u2, s1, s2 = _s(_mul(_c(x1, x2, y1z2, y2z1), _c(z2z2, z1z1, z2z2, z1z1)), 4)
    h, rh = _s(_sub(_c(u2, s2), _c(u1, s1)), 2)
    hh_T = _T(h, h)
    hh = _R([(hh_T, 1)])
    t4 = _T(_c(h, u1), _c(hh, hh))  # h^3, u1 h^2
    hhh_T, v_T = _s(t4, 2)
    j, v = _s(_R([(t4, 4)]), 2)
    zh = _add(z1, z2)
    rh2_T, zh2_T = _s(_T(_c(rh, zh), _c(rh, zh)), 2)
    x3, zzt = _RR([(rh2_T, 4), (hhh_T, -4), (v_T, -8)], [(zh2_T, 1), (z1z1_T, -1), (z2z2_T, -1)])
    ta, tb = _s(_T(_c(rh, s1), _c(_sub(v, x3), j)), 2)
    y3, z3 = _RR([(ta, 2), (tb, -2)], [(_T(zzt, h), 1)])
    h_zero, r_zero = _s(lz._p_is_zero(LZ, _c(h, rh)), 2)
    both = ~p.inf & ~q.inf
    same = h_zero & r_zero & both
    out = G1L(x3, y3, z3, h_zero & ~r_zero & both)
    if dbl and bool(same.any()):
        idx = same.nonzero()[:, 0]
        d = _p_double_l(_take(p, idx))
        out = G1L(*(getattr(out, k).index_copy(1, idx, getattr(d, k)) for k in ("x", "y", "z")), out.inf)
        same = torch.zeros_like(same)
    out = select_l(p.inf, q, out)
    return select_l(q.inf & ~p.inf, p, out), same.any()


def _p_double_l(p: G1L) -> G1L:
    """dbl-2009-l."""
    x, y, z = p.x, p.y, p.z
    yy_T, yz_T, a_T = _s(_T(_c(y, y, x), _c(y, z, x)), 3)
    b, z3 = _RR([(yy_T, 1)], [(yz_T, 2)])
    xb = _add(x, b)
    c_T, xb2_T = _s(_T(_c(b, xb), _c(b, xb)), 2)
    d, e = _RR([(xb2_T, 2), (a_T, -2), (c_T, -2)], [(a_T, 3)])
    x3 = _sub(_R([(_T(e, e), 1)]), _add(d, d))
    y3 = _R([(_T(e, _sub(d, x3)), 1), (c_T, -8)])
    return G1L(x3, y3, z3, p.inf)


def _take(p: G1L, idx) -> G1L:
    return G1L(p.x[:, idx], p.y[:, idx], p.z[:, idx], p.inf[idx])


def _cat(*ps: G1L) -> G1L:
    return G1L(*(torch.cat([getattr(p, k) for p in ps], dim=-1) for k in ("x", "y", "z")),
               torch.cat([p.inf for p in ps]))


def _plain_window_sums(px, py, sd, c: int, complete: bool = True, lane_radix: int | None = None):
    """The reference's ``_window_sums`` on (21, G, Lw, S) int64 sorted
    leaves and (G, N) sorted digits -> (window sums, flat G1L over G; flag).
    ``complete``: the boundary tree doubles where its inputs are equal (L's
    order); else it raises the reference's flag there. ``lane_radix``: the
    lane offsets in kernel L's association (``_lane_offsets``) in place of
    the reference's two blocked scans."""
    _, G, Lw, S = px.shape
    dev = px.device
    B = 1 << c
    acc = _flat_pt(identity_l((G * Lw,), dev))
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    prefixes = []
    for s in range(S):
        acc, f = _p_madd_l(acc, px[..., s].reshape(L13, -1), py[..., s].reshape(L13, -1))
        flag = flag | f
        prefixes.append(torch.stack([acc.x, acc.y, acc.z]))  # (3, 21, G*Lw)
    wxyz = torch.stack(prefixes, dim=-1).reshape(3, L13, G, Lw * S)  # position lane*S + s
    totals = acc

    A = 1
    while A * A < Lw:
        A *= 2
    Bz = Lw // A

    def exscan(pts: G1L, nblk: int, blen: int):
        """Exclusive scan over blen of flat (G*nblk*blen) points (their inf
        flags dropped, as the reference's) -> (offsets, totals, flag)."""
        ins = G1L(*(c_.reshape(L13, G * nblk, blen) for c_ in (pts.x, pts.y, pts.z)),
                  torch.zeros(G * nblk, blen, dtype=torch.bool, device=dev))
        acc = _flat_pt(identity_l((G * nblk,), dev))
        fl = torch.zeros((), dtype=torch.bool, device=dev)
        offs = []
        for b in range(blen):
            offs.append(acc)
            acc, f = _p_add_l(acc, G1L(ins.x[..., b], ins.y[..., b], ins.z[..., b], ins.inf[:, b]))
            fl = fl | f
        off = G1L(*(torch.stack([getattr(o, k) for o in offs], dim=-1).reshape(L13, -1) for k in ("x", "y", "z")),
                  torch.stack([o.inf for o in offs], dim=-1).reshape(-1))
        return off, acc, fl

    if lane_radix is None:
        within_o, blk_tot, f1 = exscan(totals, A, Bz)  # (G*A*Bz), (G*A)
        blk_o, grand, f2 = exscan(blk_tot, 1, A)  # (G*A), (G)
        bo = _take(blk_o, torch.arange(G * A, device=dev).reshape(G * A, 1).expand(G * A, Bz).reshape(-1))
        off, f3 = _p_add_l(bo, within_o)  # lane g*Lw + a*Bz + b
        flag = flag | f1 | f2 | f3
    else:  # groups of lane_radix, level by level, then the offsets back down
        levels, cur, per = [], totals, Lw
        for blen in lane_groups(Lw, lane_radix):
            wo, cur, f = exscan(cur, per // blen, blen)
            flag = flag | f
            levels.append((wo, blen))
            per //= blen
        grand, off = cur, levels[-1][0]
        for wo, blen in reversed(levels[:-1]):
            up = torch.arange(wo.inf.shape[0], device=dev) // blen
            off, f = _p_add_l(_take(off, up), wo)
            flag = flag | f

    # the prefix sums at the B-1 boundaries, each distinct (window, position) once
    n = Lw * S
    t = torch.arange(1, B, dtype=sd.dtype, device=dev).expand(G, B - 1).contiguous()
    pos = torch.searchsorted(sd.contiguous(), t, side="left") - 1  # (G, B-1): last index < t
    is_neg = pos < 0
    posc = pos.clamp(min=0)
    keys = (torch.arange(G, device=dev)[:, None] * n + posc).reshape(-1)
    uk, inv = torch.unique(keys, return_inverse=True)
    ug, up = uk // n, uk % n
    within = G1L(*(wxyz[k][:, ug, up] for k in range(3)), torch.zeros(uk.shape[0], dtype=torch.bool, device=dev))
    offp = _take(off, ug * Lw + up // S)
    ps, f = _p_add_l(offp, within)
    flag = flag | f
    K = B - 1
    m = 1
    while m < K:
        m *= 2
    ident = _flat_pt(identity_l((1,), dev))
    zero = torch.zeros(L13, 1, dtype=torch.int64, device=dev)
    table = _cat(ps, ident, G1L(zero, zero, zero, torch.ones(1, dtype=torch.bool, device=dev)))
    u = uk.shape[0]
    ids = torch.where(is_neg, u, inv.reshape(G, K))
    ids = torch.cat([ids, torch.full((G, m - K), u + 1, dtype=ids.dtype, device=dev)], dim=1)
    # the log-depth tree over the boundaries, each distinct pair once
    while m > 1:
        m //= 2
        pair = ids[:, :m] * table.inf.shape[0] + ids[:, m : 2 * m]
        up_, inv = torch.unique(pair.reshape(-1), return_inverse=True)
        table, f = _p_add_l(_take(table, up_ // table.inf.shape[0]), _take(table, up_ % table.inf.shape[0]),
                            dbl=complete)
        flag = flag | f
        ids = inv.reshape(G, m)
    s_sum = _take(table, ids[:, 0])

    # G_w = (B-1) * Total - sum PS
    acc = _flat_pt(identity_l((G,), dev))
    cur = grand
    for _ in range(c):
        acc, f = _p_add_l(acc, cur)
        flag = flag | f
        cur = _p_double_l(cur)
    neg_y = _sub(torch.zeros_like(s_sum.y), s_sum.y)
    gw, f = _p_add_l(acc, G1L(s_sum.x, neg_y, s_sum.z, s_sum.inf))
    return gw, flag | f


def _plain_horner(gw: G1L, c: int):
    dev = gw.x.device
    acc = _flat_pt(identity_l((1,), dev))
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    for w in reversed(range(gw.inf.shape[0])):
        for _ in range(c):
            acc = _p_double_l(acc)
        acc, f = _p_add_l(acc, _take(gw, slice(w, w + 1)))
        flag = flag | f
    return acc, flag


def digit_windows(scalars: torch.Tensor, c: int, num_bits: int = 254) -> torch.Tensor:
    """(N, 8) standard-form words -> (W, N) int64 c-bit digits."""
    return torch.stack([pip.scalar_window(scalars, w, c) for w in range(num_windows(c, num_bits))])


def num_windows(c: int, num_bits: int = 254) -> int:
    return (num_bits + c - 1) // c


def geometry(n: int, c: int, lanes: int, wgroup: int, num_bits: int = 254) -> dict:
    """The reference's shapes: W windows, Lw lanes of S steps, the exscan's
    A blocks of Bz lanes, B = 2^c buckets and the tree's m >= B - 1."""
    if not 1 <= c <= 16 or n < 1 or lanes < 1 or wgroup < 1:
        raise ValueError(f"msm13: need 1 <= c <= 16, n, lanes, wgroup >= 1 (c={c}, n={n})")
    lw = min(lanes, n)
    while n % lw:
        lw //= 2
    a = 1
    while a * a < lw:
        a *= 2
    if lw % a:
        raise ValueError(f"msm13: Lw={lw} does not split into {a} blocks")
    m = 1
    while m < (1 << c) - 1:
        m *= 2
    return {"W": num_windows(c, num_bits), "Lw": lw, "S": n // lw, "A": a, "Bz": lw // a, "B": 1 << c, "m": m}


def _plain_msm13(ax, ay, scalars, c, num_bits, lanes, wgroup, keep_windows=False, complete=True,
                 lane_radix=None):
    n = ax.shape[1]
    geo = geometry(n, c, lanes, wgroup, num_bits)
    W, Lw, S = geo["W"], geo["Lw"], geo["S"]
    ax, ay = ax.to(torch.int64), ay.to(torch.int64)
    sd, perm = torch.sort(digit_windows(scalars, c, num_bits), dim=1, stable=True)
    sums, flag, group_flags = [], torch.zeros((), dtype=torch.bool, device=ax.device), []
    for g0 in range(0, W, wgroup):
        g1 = min(g0 + wgroup, W)
        pg = perm[g0:g1].reshape(-1)
        gw, f = _plain_window_sums(ax[:, pg].reshape(L13, g1 - g0, Lw, S), ay[:, pg].reshape(L13, g1 - g0, Lw, S),
                                   sd[g0:g1], c, complete, lane_radix)
        sums.append(gw)
        group_flags.append(f)
        flag = flag | f
    gw = _cat(*sums)
    acc, f = _plain_horner(gw, c)
    out = G1L(*(v.to(torch.int32) for v in (acc.x, acc.y, acc.z)), acc.inf)
    if keep_windows:
        return out, int(flag | f), G1L(*(v.to(torch.int32) for v in (gw.x, gw.y, gw.z)), gw.inf), \
            [int(v) for v in group_flags]
    return out, int(flag | f)


# ---------------------------------------------------------------------------
# Kernel L launches
# ---------------------------------------------------------------------------

LANE_RADIX = 8  # kernel L's lane offsets: exclusive scans over groups of 8, level by level (_lane_offsets)


def lane_groups(lw: int, radix: int = LANE_RADIX) -> list[int]:
    """The group sizes of L's lane-offset scans, level by level, for Lw
    lanes: each level's groups take the largest divisor of what is left
    that is at most ``radix`` (or, where only 1 is, its smallest prime
    factor), so that no group straddles two windows; their product is Lw
    (8, 8, 8, 8 at 4096 lanes; 6, 2 at 12; [1] at 1)."""
    out, per = [], lw
    while True:
        blen = next((d for d in range(min(radix, per), 1, -1) if per % d == 0), 0)
        blen = blen or next((d for d in range(2, per + 1) if per % d == 0), 1)
        out.append(blen)
        per //= blen
        if per == 1:
            return out
RW = 40  # u32 words of one of L's point records (csrc/msm13.cu): x, y, z packed at 0, 12, 24, the flag at 36
BW = 24  # u32 words of one base of the point-major copy: x packed at 0, y at 12


def fragment_matrix_l(scale: int) -> np.ndarray:
    """The (42, 164) reduction matrix of one scale as kernel L reads it:
    padded to (48, 192) in kernel J's K order (column 4 j + byte is byte
    ``byte`` of product column j), cut into mma.m16n8k32 A fragments (3
    tiles, 6 steps, 32 lanes, 4 u32) whose K axis is L's: the thread of
    lane (g, t) takes, at step s, the words 12 t + 2 s and 12 t + 2 s + 1
    of a product column row as its two B registers, so that its six steps
    read three contiguous 16-byte quads of the row."""
    ct = lz._scaled_C(LZ, (int(scale),))
    a = np.zeros((16 * lz.MMA_TILES, 32 * lz.MMA_STEPS), dtype=np.uint8)
    for kk in range(lz.NBYTES):
        a[: 2 * L13, kk : 4 * lz.NPROD : 4] = ct[:, kk * lz.NPROD : (kk + 1) * lz.NPROD]
    out = np.zeros((lz.MMA_TILES, lz.MMA_STEPS, 32, 4), dtype=np.uint32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for reg, (dr, half) in enumerate(((0, 0), (8, 0), (0, 1), (8, 1))):
            for m in range(lz.MMA_TILES):
                for s in range(lz.MMA_STEPS):
                    w = 12 * t + 2 * s + half
                    out[m, s, lane, reg] = int.from_bytes(a[16 * m + g + dr, 4 * w : 4 * w + 4].tobytes(), "little")
    return out


@lru_cache(maxsize=4)
def _mats(device: str) -> torch.Tensor:
    """The eight scaled reduction matrices (csrc/lazy13.cuh l13::Scale
    order) in L's fragment order, one contiguous device array."""
    return ff.to_tensor(np.concatenate([fragment_matrix_l(s).reshape(-1) for s in SCALES]), device)


def _field():
    return ctypes.addressof(lz.field_struct(LZ))


def _pack(a: torch.Tensor) -> torch.Tensor:
    """(21, N) limbs (each below 2^16) -> (N, 12) u32 words as int32: word i
    holds limbs 2 i and 2 i + 1, word 10 limb 20, word 11 zero."""
    a = a.to(torch.int64)
    lo, hi = a[0::2], torch.cat([a[1::2], torch.zeros_like(a[:1])])  # (11, N) each
    w = torch.cat([lo | (hi << 16), torch.zeros_like(a[:1])]) & 0xFFFFFFFF
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32).T


def _unpack(w: torch.Tensor) -> torch.Tensor:
    """(N, 12) packed words -> (21, N) int32 limbs (``_pack``'s inverse)."""
    w = w.T.to(torch.int64) & 0xFFFFFFFF
    out = torch.stack([w[:11] & 0xFFFF, w[:11] >> 16], dim=1).reshape(22, -1)[:L13]
    return out.to(torch.int32)


def pack_bases(ax13: torch.Tensor, ay13: torch.Tensor) -> torch.Tensor:
    """Affine lazy-13 bases (21, N) x 2 -> the point-major copy kernel L
    reads, (N, 24) int32: x packed in words 0-10, y in 12-22 (two 16-bit
    limbs a word; lazy limbs are below 2^13 + 2^6)."""
    return torch.cat([_pack(ax13), _pack(ay13)], dim=1).contiguous()


def unpack_bases(bases: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return _unpack(bases[:, :12]), _unpack(bases[:, 12:])


def pack_points(p: G1L) -> torch.Tensor:
    """Points of any batch -> (count, 40) int32 records of kernel L."""
    xyz = [_pack(lz._flat(c)) for c in (p.x, p.y, p.z)]
    flag = p.inf.reshape(-1, 1).to(torch.int32)
    return torch.cat([*xyz, flag, torch.zeros_like(flag.expand(-1, 3))], dim=1).contiguous()


def unpack_points(rec: torch.Tensor, batch) -> G1L:
    return G1L(*(_unpack(rec[:, 12 * k : 12 * k + 12]).reshape(L13, *batch) for k in range(3)),
               (rec[:, 36] != 0).reshape(batch))


def run_end_tags(sd: torch.Tensor, c: int) -> torch.Tensor:
    """The rule by which kernel L's scan stores a prefix: (W, N) sorted
    digits -> (W, N) tags, the digit where its position ends the digit's
    run and the digit is below B - 1 (so that some boundary reads that
    prefix), else -1."""
    nxt = torch.cat([sd[:, 1:], torch.full_like(sd[:, :1], -1)], dim=1)
    return torch.where((sd != nxt) & (sd < (1 << c) - 1), sd, torch.full_like(sd, -1))


def _unstack(xyz, inf, batch) -> G1L:
    return G1L(*(xyz[k].reshape(L13, *batch) for k in range(3)), inf.reshape(batch))


def _launch(symbol: str, device: str, *args) -> None:
    kernels.launch("msm13", "msm13", symbol, _field(), _mats(device).data_ptr(), *args)


def _launch_point_op(op: str, p: G1L, q=None, qx=None, qy=None):
    dev = p.x.device
    batch = p.batch_shape
    prec = pack_points(p)
    n = prec.shape[0]
    out = torch.empty(n, RW, dtype=torch.int32, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    if n:
        if op == "add":
            qrec = pack_points(q)
        elif op == "madd":
            qrec = pack_bases(lz._flat(qx), lz._flat(qy))
        else:
            qrec = prec
        _launch("zk_msm13_point_op", str(dev), {"add": 0, "madd": 1, "double": 2}[op], out.data_ptr(),
                prec.data_ptr(), qrec.data_ptr(), flag.data_ptr(), n)
    return unpack_points(out, batch), flag


def _lane_offsets(totals, W, Lw, flag, pts, marks):
    """Each lane's offset (the exclusive prefix of the lane totals of its
    window, (W Lw) records) and each window's total (W): exclusive scans
    over groups of at most LANE_RADIX items (``lane_groups``: no group
    straddles two windows), level by level up to one group a window, then
    the offsets back down (an item's offset = its group's offset + its
    offset in the group). The reference scans A blocks of Bz lanes and then
    the A block totals, two chains of ~sqrt(Lw) dependent additions (129 at
    Lw = 4096); here a chain has at most LANE_RADIX additions a level (35
    in all at Lw = 4096). So L's words differ from the reference's from
    here on (they are the plain version's with ``lane_radix=LANE_RADIX``),
    and its affine points and flags agree with the reference's only where
    no repeated base meets itself: with a repeated base, one association
    can raise the flag where the other does not."""
    sdev = str(totals.device)
    levels, cur = [], totals
    for blen in lane_groups(Lw):
        count = cur.shape[0]
        wo, tots = pts(count), pts(count // blen)
        _launch("zk_msm13_exscan", sdev, wo.data_ptr(), tots.data_ptr(), cur.data_ptr(), count // blen, blen,
                flag.data_ptr())
        levels.append((wo, blen))
        cur = tots
    _mark(marks, "exscan_up")
    off = levels[-1][0]
    for wo, blen in reversed(levels[:-1]):
        nxt = pts(wo.shape[0])
        _launch("zk_msm13_offsets", sdev, nxt.data_ptr(), off.data_ptr(), wo.data_ptr(), wo.shape[0], blen,
                flag.data_ptr())
        off = nxt
    _mark(marks, "offsets_down")
    return off, cur


def _launch_msm13(ax, ay, scalars, c, num_bits, lanes, wgroup, keep_windows=False, marks=None, bases=None):
    dev = ax.device
    n = ax.shape[1]
    geo = geometry(n, c, lanes, wgroup, num_bits)
    W, Lw, S, B, m = (geo[k] for k in ("W", "Lw", "S", "B", "m"))
    sdev = str(dev)
    for name, t in (("ax13", ax), ("ay13", ay)):
        if t.device.type != "cuda" or t.dtype != torch.int32 or t.shape != (L13, n):
            raise ValueError(f"msm13 {name}: expected a CUDA int32 (21, {n}) tensor")
    if bases is None:
        bases = pack_bases(ax, ay)
    kernels.check_cuda_tensor("msm13 bases", bases, torch.int32, BW)
    if bases.shape[0] != n:
        raise ValueError(f"msm13: {bases.shape[0]} packed bases for {n} points")
    scalars = scalars.contiguous()
    kernels.check_cuda_tensor("msm13 scalars", scalars, torch.int32, ff.W)

    def pts(count):
        return torch.empty(count, RW, dtype=torch.int32, device=dev)

    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    digits = torch.empty(W, n, dtype=torch.int32, device=dev)
    _launch("zk_msm13_digits", sdev, digits.data_ptr(), scalars.data_ptr(), n, c, W)
    _mark(marks, "digits")
    sd, perm = sort_digits(digits, signed=False)  # stable, on 16-bit keys (c <= 16), as kernel C's
    del digits
    _mark(marks, "sort")
    within, totals = pts(W * B), pts(W * Lw)
    _launch("zk_msm13_scan", sdev, within.data_ptr(), totals.data_ptr(), bases.data_ptr(), sd.data_ptr(),
            perm.data_ptr(), n, W, Lw, S, B, flag.data_ptr())
    _mark(marks, "scan")
    del perm
    off, grand = _lane_offsets(totals, W, Lw, flag, pts, marks)
    del totals
    bacc = pts(W * m)
    _launch("zk_msm13_boundaries", sdev, bacc.data_ptr(), within.data_ptr(), off.data_ptr(), sd.data_ptr(), W, n, Lw,
            S, B, m, flag.data_ptr())
    _mark(marks, "boundaries")
    del within, off, sd
    half = m  # level by level into a fresh array: (W, half) sums of (W, 2 half)
    while half > 1:
        half //= 2
        nxt = pts(W * half)
        _launch("zk_msm13_tree", sdev, nxt.data_ptr(), bacc.data_ptr(), W, half)
        bacc = nxt
        _mark(marks, "tree_top" if half == m // 2 else "tree_rest")
    gw = pts(W)
    scratch = pts(3 * -(-W // 128) * 128)
    _launch("zk_msm13_window", sdev, gw.data_ptr(), scratch.data_ptr(), bacc.data_ptr(), grand.data_ptr(), W, c,
            flag.data_ptr())
    _mark(marks, "window")
    out = torch.empty(3, L13, 1, dtype=torch.int32, device=dev)
    out_inf = torch.empty(1, dtype=torch.bool, device=dev)
    _launch("zk_msm13_horner", sdev, out.data_ptr(), out_inf.data_ptr(), scratch.data_ptr(), gw.data_ptr(), W, c,
            flag.data_ptr())
    _mark(marks, "horner")
    result = _unstack(out, out_inf, (1,))
    if keep_windows:
        return result, int(flag.item()), unpack_points(gw, (W,)), None
    return result, int(flag.item())


# ---------------------------------------------------------------------------
# Public operations
# ---------------------------------------------------------------------------

def _on_cpu(*ts) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"msm13: unsupported devices {devs}")


def _public(p: G1L, batch) -> G1L:
    return G1L(*(c.to(torch.int32).reshape(L13, *batch) for c in (p.x, p.y, p.z)), p.inf.reshape(batch))


def madd_l(p: G1L, qx: torch.Tensor, qy: torch.Tensor):
    """Mixed addition p + (qx, qy) (the leaf is never the identity) ->
    (result, doubling flag 0/1: p equals the leaf on some lane)."""
    if _on_cpu(p.x, qx, qy):
        out, f = _p_madd_l(_flat_pt(p), lz._flat(qx).to(torch.int64), lz._flat(qy).to(torch.int64))
        return _public(out, p.batch_shape), int(f)
    out, flag = _launch_point_op("madd", p, qx=qx, qy=qy)
    return out, int(flag.item())


def add_l(p: G1L, q: G1L):
    """Complete Jacobian addition -> (result, doubling flag 0/1)."""
    if _on_cpu(p.x, q.x):
        out, f = _p_add_l(_flat_pt(p), _flat_pt(q))
        return _public(out, p.batch_shape), int(f)
    if p.batch_shape != q.batch_shape:
        raise ValueError(f"add_l: batch shapes differ {p.batch_shape} vs {q.batch_shape}")
    out, flag = _launch_point_op("add", p, q=q)
    return out, int(flag.item())


def double_l(p: G1L) -> G1L:
    if _on_cpu(p.x):
        return _public(_p_double_l(_flat_pt(p)), p.batch_shape)
    return _launch_point_op("double", p)[0]


def msm13(ax13: torch.Tensor, ay13: torch.Tensor, scalars: torch.Tensor, c: int = 16, num_bits: int = 254,
          lanes: int = 4096, wgroup: int = 8, *, bases: torch.Tensor | None = None, marks: list | None = None):
    """Variable-base MSM over affine lazy-13 bases (21, N) (no identity)
    and (N, 8) standard-form scalar words -> (G1L of batch (1,), doubling
    flag 0/1). On the card, ``bases`` is their point-major copy
    (``pack_bases``; made here when None) and ``marks`` collects a CUDA
    event after each stage of kernel L (``scripts/probe_msm13.py``,
    ``chip_smoke.py``)."""
    if ax13.shape != ay13.shape or ax13.dim() != 2 or ax13.shape[0] != L13:
        raise ValueError(f"msm13: bases must be two (21, N) tensors, got {tuple(ax13.shape)}, {tuple(ay13.shape)}")
    if scalars.shape != (ax13.shape[1], ff.W):
        raise ValueError(f"msm13: expected scalars {(ax13.shape[1], ff.W)}, got {tuple(scalars.shape)}")
    if _on_cpu(ax13, ay13, scalars):
        return _plain_msm13(ax13, ay13, scalars, c, num_bits, lanes, wgroup)
    return _launch_msm13(ax13, ay13, scalars, c, num_bits, lanes, wgroup, marks=marks, bases=bases)


def to_point(p: G1L) -> torch.Tensor:
    """Lazy-13 Jacobian of batch (...) -> (..., 3, 8) Montgomery Jacobian
    points of the port (identity as x = y = 1, z = 0); the reference's
    ``to_g1t``."""
    batch = p.batch_shape
    coords = [ff.to_mont(FQ, lz.to_words(lz.canon13(LZ, c))) for c in (p.x, p.y, p.z)]
    out = torch.stack(coords, dim=-2)
    ident = group.identity(batch, out.device)
    return torch.where(p.inf[..., None, None], ident, out)


def affine_l13(points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, 3, 8) Montgomery Jacobian points (no identity) -> affine
    standard-form lazy-13 (ax13, ay13), each (21, N): z inverted by A's
    ``inv``, then ``from_mont`` and ``from_words``."""
    x, y, z = points.unbind(-2)
    zinv = ff.inv(FQ, z)
    zi2 = ff.mont_mul(FQ, zinv, zinv)
    ax = ff.mont_mul(FQ, x, zi2)
    ay = ff.mont_mul(FQ, y, ff.mont_mul(FQ, zi2, zinv))
    return lz.from_words(ff.from_mont(FQ, ax)), lz.from_words(ff.from_mont(FQ, ay))


class Msm13:
    """Commit engine over fixed bases (the SRS): converts the (N, 3, 8)
    Jacobian Montgomery points to affine lazy-13 once and maps (N, 8)
    standard-form scalars to one (3, 8) point. On a doubling flag (a
    discrete-log relation between the bases met) it falls back to G's
    Pippenger MSM over the same points and counts it in ``fallbacks``."""

    def __init__(self, points: torch.Tensor, c: int = 16, lanes: int = 4096, wgroup: int = 8):
        if points.dim() != 3 or points.shape[1:] != (3, ff.W):
            raise ValueError(f"Msm13 bases must be (N, 3, 8), got {tuple(points.shape)}")
        geometry(points.shape[0], c, lanes, wgroup)
        self.points = points.contiguous()
        self.ax13, self.ay13 = affine_l13(self.points)
        self.bases13 = pack_bases(self.ax13, self.ay13)  # the point-major copy kernel L reads
        self.c, self.lanes, self.wgroup = c, lanes, wgroup
        self.fallbacks = 0

    def raw(self, scalars: torch.Tensor, *, marks: list | None = None):
        """``msm13`` over the engine's bases: (G1L of batch (1,), flag)."""
        return msm13(self.ax13, self.ay13, scalars, c=self.c, lanes=self.lanes, wgroup=self.wgroup,
                     bases=self.bases13, marks=marks)

    def __call__(self, scalars: torch.Tensor) -> torch.Tensor:
        acc, flag = self.raw(scalars)
        if flag:
            self.fallbacks += 1
            return pip.msm(self.points, scalars)
        return to_point(acc)[0]


PLAIN = {"madd_l": _p_madd_l, "add_l": _p_add_l, "double_l": _p_double_l, "msm13": _plain_msm13}
