"""Kernel L's launch plan (``zkevm_tpu_torch/ec/msm13.py``, ``csrc/msm13.cu``)
modelled on the CPU against the plain version, at n <= 64 and c = 4 and 16:

- the point-major copy of the bases (``pack_bases``) and the point records
  (``pack_points``) round-trip to the (21, N) limbs;
- the reduction matrices in L's fragment order, read from a product slot
  laid out as the kernel's stores lay it out (rotated quads, a column-free
  quad of garbage), give the plain reduction's sums for every scale;
- the scan's run-end tags (``run_end_tags``) mark exactly the positions
  whose prefixes the boundaries read;
- the stages as L runs them (one launch of each for every window; prefixes
  kept only at run ends, indexed by digit; lane offsets by exclusive scans
  over groups of at most ``LANE_RADIX`` lanes that divide a window's lanes
  (``lane_groups``), level by level, where the reference
  scans blocks of ~sqrt(Lw); the boundaries read the prefixes back with a
  lane offset; the tree copies identity inputs, doubles word-equal inputs
  without adding and adds the rest), written with the plain point
  formulas, give the plain version's window sums word for word, flags
  included, when the plain version runs its lane offsets in L's
  association (``lane_radix``; every other stage keeps the reference's
  order), and with the reference's lane offsets in their place;
- where it raises no flag, each association's window sums are the golden
  model's (a repeated base can make one of them flag and not the other).

Every case takes seconds."""

import numpy as np
import pytest
import torch

from zkevm_tpu_torch.ec import goldens as g1g, group, msm13
from zkevm_tpu_torch.ff import field as ff, lazy13 as lz
from zkevm_tpu_torch.ff.goldens import FR_MOD

L13 = 21


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _lazy_limbs(rng, n):
    """(21, n) int32 limbs anywhere in the lazy range (below 2^13 + 2^6)."""
    return torch.from_numpy(rng.integers(0, (1 << 13) + (1 << 6), (L13, n)).astype(np.int32))


@pytest.mark.parametrize("n", [1, 16, 64])
def test_pack_bases_round_trips(n):
    rng = np.random.default_rng(n)
    ax, ay = _lazy_limbs(rng, n), _lazy_limbs(rng, n)
    ax[:, 0] = (1 << 13) + (1 << 6) - 1  # the largest lazy limbs
    packed = msm13.pack_bases(ax, ay)
    assert packed.shape == (n, msm13.BW) and packed.dtype == torch.int32 and packed.is_contiguous()
    assert not packed[:, 11].any() and not packed[:, 23].any()
    got_x, got_y = msm13.unpack_bases(packed)
    assert torch.equal(got_x, ax) and torch.equal(got_y, ay)
    words = packed.to(torch.int64) & 0xFFFFFFFF
    assert int(words[0, 3]) == int(ax[6, 0]) | int(ax[7, 0]) << 16
    assert int(words[0, 12 + 10]) == int(ay[20, 0])


def test_engine_keeps_the_point_major_copy():
    rng = np.random.default_rng(5)
    pts = group.from_affine_ints([g1g.random_point(rng) for _ in range(16)], "cpu")
    engine = msm13.Msm13(pts, c=4, lanes=4)
    assert torch.equal(engine.bases13, msm13.pack_bases(engine.ax13, engine.ay13))
    got_x, got_y = msm13.unpack_bases(engine.bases13)
    assert torch.equal(got_x, engine.ax13) and torch.equal(got_y, engine.ay13)


def test_point_records_round_trip():
    rng = np.random.default_rng(7)
    p = msm13.G1L(_lazy_limbs(rng, 33), _lazy_limbs(rng, 33), _lazy_limbs(rng, 33),
                  torch.from_numpy(rng.integers(0, 2, 33).astype(bool)))
    rec = msm13.pack_points(p)
    assert rec.shape == (33, msm13.RW) and torch.equal(rec[:, 36], p.inf.to(torch.int32))
    q = msm13.unpack_points(rec, (3, 11))
    for k in ("x", "y", "z", "inf"):
        assert torch.equal(getattr(q, k).reshape(getattr(p, k).shape), getattr(p, k))


def _bytes4(w):
    return [(int(w) >> (8 * i)) & 255 for i in range(4)]


@pytest.mark.parametrize("scale", msm13.SCALES)
def test_fragments_read_from_the_slot_give_the_plain_reduction(scale):
    """mma.m16n8k32 over L's fragments and the slot as k_scan's stores
    leave it: quad q of element e at quad (q + ((e >> 1) & 3)) mod 12 of
    its 48-word row, the unwritten quad garbage; thread (g, t) reads quads
    3 t .. 3 t + 2 of element 8 nb + g."""
    rng = np.random.default_rng(abs(scale) + 10 * (scale < 0))
    frag = msm13.fragment_matrix_l(scale)
    cols = rng.integers(0, 1 << 31, (32, lz.NPROD), dtype=np.int64)
    slot = rng.integers(0, 1 << 32, (32, 48), dtype=np.int64)
    for e in range(32):
        for q in range(11):
            pq = (q + ((e >> 1) & 3)) % 12
            for u in range(4):
                slot[e, 4 * pq + u] = cols[e, 4 * q + u] if 4 * q + u < lz.NPROD else 0
    acc = np.zeros((48, 32), dtype=np.int64)
    for m in range(3):
        for s in range(6):
            a = np.zeros((16, 32), dtype=np.int64)
            b = np.zeros((32, 32), dtype=np.int64)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
                    a[g + dr, dk + 4 * t : dk + 4 * t + 4] = _bytes4(frag[m, s, lane, reg])
                for nb in range(4):
                    e = nb * 8 + g
                    pq = (3 * t + (s >> 1) + ((g >> 1) & 3)) % 12
                    quad = slot[e, 4 * pq : 4 * pq + 4]
                    lo, hi = (quad[2], quad[3]) if s & 1 else (quad[0], quad[1])
                    b[4 * t : 4 * t + 4, e] = _bytes4(lo)
                    b[16 + 4 * t : 16 + 4 * t + 4, e] = _bytes4(hi)
            acc[16 * m : 16 * m + 16] += a @ b
    limbs = acc[0:42:2] + (acc[1:42:2] << 8)  # acc_finish's words before the carries
    want = lz._matrix(lz.ctx_fq(), (scale,), "cpu").to(torch.int64).numpy()  # (21, 164), K in byte order 4 j + k
    by = np.stack([(cols >> (8 * k)) & 255 for k in range(4)], axis=-1).reshape(32, -1)
    assert np.array_equal(limbs, want @ by.T)
    assert not acc[42:].any()


def _digits(rng, n, c, kind):
    if kind == "0/1":
        vals = [int(v) for v in rng.integers(0, 2, n)]
    else:
        vals = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(n)]
        vals[0], vals[-1] = 0, FR_MOD - 1
    return vals, msm13.digit_windows(ff.to_tensor(ff.words_from_ints(vals), "cpu"), c)


@pytest.mark.parametrize("n,c,kind", [(16, 4, "random"), (64, 4, "random"), (64, 4, "0/1"), (16, 16, "random"),
                                      (64, 16, "random"), (64, 16, "0/1")])
def test_run_end_tags_are_the_boundaries_reads(n, c, kind):
    rng = np.random.default_rng(n + c)
    _, digits = _digits(rng, n, c, kind)
    sd = torch.sort(digits, dim=1, stable=True).values
    tags = msm13.run_end_tags(sd, c)
    B = 1 << c
    t = torch.arange(1, B, dtype=sd.dtype).expand(sd.shape[0], B - 1).contiguous()
    pos = torch.searchsorted(sd.contiguous(), t, side="left") - 1  # the plain version's reads
    for w in range(sd.shape[0]):
        read = set(pos[w][pos[w] >= 0].tolist())
        tagged = set((tags[w] >= 0).nonzero()[:, 0].tolist())
        assert read == tagged
        assert all(int(tags[w, p]) == int(sd[w, p]) for p in tagged)


def _flat(p):
    return msm13._flat_pt(p)


def _records(p):
    """A flat int64 G1L as a list of per-lane tuples (words and flag)."""
    return [(tuple(p.x[:, i].tolist()), tuple(p.y[:, i].tolist()), tuple(p.z[:, i].tolist()), bool(p.inf[i]))
            for i in range(p.inf.shape[0])]


def _lanes(pts):
    x, y, z, inf = zip(*pts)
    col = lambda v: torch.tensor(v, dtype=torch.int64).T.reshape(L13, -1)  # noqa: E731
    return msm13.G1L(col(x), col(y), col(z), torch.tensor(inf))


def _add(p, q, q_inf=None):
    """The plain complete addition of two lists of lanes (q's flags
    replaced by q_inf where given) -> (lanes, flag)."""
    qq = _lanes(q)
    if q_inf is not None:
        qq = msm13.G1L(qq.x, qq.y, qq.z, torch.tensor(q_inf))
    out, f = msm13.PLAIN["add_l"](_lanes(p), qq)
    return _records(out), bool(f)


def _double(p):
    return _records(msm13.PLAIN["double_l"](_lanes(p)))


def _affine(pts):
    return group.to_affine_ints(msm13.to_point(_lanes(pts)))


IDENTITY = ((1,) + (0,) * 20, (1,) + (0,) * 20, (0,) * 21, True)
PADDING = ((0,) * 21, (0,) * 21, (0,) * 21, True)


def _plan_window_sums(px, py, sd, c, Lw, S, radix):
    """L's stages for every window at once, on the plain point formulas,
    one batch of lanes per dependent step, its lane offsets over
    ``msm13.lane_groups(Lw, radix)`` (None: the reference's blocks):
    (window sums as lanes, flag)."""
    W = sd.shape[0]
    n = Lw * S
    B = 1 << c
    g = msm13.geometry(n, c, Lw, W)
    A, Bz, m = g["A"], g["Bz"], g["m"]
    tags = msm13.run_end_tags(sd, c)
    flag = False
    # k_scan: each (window, lane) walks its S leaves, storing at run ends
    acc = _flat(msm13.identity_l((W * Lw,), "cpu"))
    within = {}
    for s in range(S):
        pos = torch.arange(Lw) * S + s
        acc, f = msm13.PLAIN["madd_l"](acc, px[:, :, pos].reshape(L13, -1), py[:, :, pos].reshape(L13, -1))
        flag |= bool(f)
        rec = _records(acc)
        for w in range(W):
            for lane in range(Lw):
                d = int(tags[w, int(pos[lane])])
                if d >= 0:
                    within[(w, d)] = rec[w * Lw + lane]
    totals = _records(acc)

    def exscan(items, nb, blen):  # k_exscan: flags of the inputs dropped
        nonlocal flag
        offs, cur = [None] * (nb * blen), [IDENTITY] * nb
        for b in range(blen):
            for i in range(nb):
                offs[i * blen + b] = cur[i]
            cur, f = _add(cur, [items[i * blen + b] for i in range(nb)], [False] * nb)
            flag |= f
        return offs, cur

    if radix is None:  # the reference's association
        wo, bt = exscan(totals, W * A, Bz)
        bo, grand = exscan(bt, W, A)
        off, f = _add([bo[i // Bz] for i in range(W * Lw)], wo)  # k_offsets
        flag |= f
    else:  # L's (_lane_offsets): groups of lane_groups, level by level, and back down
        levels, cur = [], totals
        for blen in msm13.lane_groups(Lw, radix):
            assert len(cur) % blen == 0 and (len(cur) // W) % blen == 0  # no group straddles two windows
            wo, cur = exscan(cur, len(cur) // blen, blen)
            levels.append((wo, blen))
        assert len(cur) == W
        grand, off = cur, levels[-1][0]
        for wo, blen in reversed(levels[:-1]):
            off, f = _add([off[i // blen] for i in range(len(wo))], wo)
            flag |= f
    # k_boundaries: a lane offset plus the prefix stored at the run end (each
    # distinct position added once: the same inputs give the same words);
    # the (W, m) inputs of the tree as ids into a table of points
    table = [IDENTITY, PADDING]
    ids = torch.ones(W, m, dtype=torch.int64)
    t = torch.arange(1, B, dtype=sd.dtype)
    pos = torch.searchsorted(sd.contiguous(), t.expand(W, B - 1).contiguous(), side="left") - 1
    ids[:, : B - 1] = 0
    wk, kk = (pos >= 0).nonzero(as_tuple=True)
    keys = wk * n + pos[wk, kk]
    uk, inv = torch.unique(keys, return_inverse=True)
    pairs = [(int(k) // n, int(k) % n) for k in uk]
    sums, f = _add([off[w * Lw + p // S] for w, p in pairs], [within[(w, int(sd[w, p]))] for w, p in pairs],
                   [False] * len(pairs))
    flag |= f
    ids[wk, kk] = inv + len(table)
    table += sums
    # k_tree: identity inputs copied, word-equal inputs doubled, the rest
    # added (and doubled where the addition meets equal points)
    half = m
    while half > 1:
        half //= 2
        p_ids, q_ids = ids[:, :half], ids[:, half : 2 * half]
        p_inf = torch.tensor([table[i][3] for i in range(len(table))])
        new = torch.where(p_inf[p_ids], q_ids, p_ids)
        both = ~p_inf[p_ids] & ~p_inf[q_ids]
        up, inv = torch.unique(p_ids[both] * len(table) + q_ids[both], return_inverse=True)
        ps = [table[int(k) // len(table)] for k in up]
        qs = [table[int(k) % len(table)] for k in up]
        eq = [i for i in range(len(ps)) if ps[i] == qs[i]]
        ne = [i for i in range(len(ps)) if ps[i] != qs[i]]
        out = [None] * len(ps)
        for i, r in zip(eq, _double([ps[i] for i in eq]) if eq else []):
            out[i] = r
        if ne:
            rs, f = _add([ps[i] for i in ne], [qs[i] for i in ne])
            if f:  # which lanes met equal points: one at a time
                rs = [(_double([ps[i]])[0] if _add([ps[i]], [qs[i]])[1] else r) for i, r in zip(ne, rs)]
            for i, r in zip(ne, rs):
                out[i] = r
        new[both] = inv + len(table)
        table += [(*r[:3], False) for r in out]
        ids = new
    # k_window: (B - 1) Total - sum PS
    acc_w, cur = [IDENTITY] * W, list(grand)
    for _ in range(c):
        acc_w, f = _add(acc_w, cur)
        flag |= f
        cur = _double(cur)
    roots = [table[int(i)] for i in ids[:, 0]]
    neg_y = lz._p_sub(lz.ctx_fq(), torch.zeros(L13, W, dtype=torch.int64),
                      torch.tensor([r[1] for r in roots], dtype=torch.int64).T)
    gw, f = _add(acc_w, [(r[0], tuple(neg_y[:, w].tolist()), r[2], r[3]) for w, r in enumerate(roots)])
    return gw, flag | f


@pytest.mark.parametrize("lw,want", [(1, [1]), (2, [2]), (8, [8]), (16, [8, 2]), (4096, [8, 8, 8, 8]),
                                     (2048, [8, 8, 8, 4]), (12, [6, 2]), (96, [8, 6, 2]), (3904, [8, 8, 61]),
                                     (4032, [8, 8, 7, 3, 3])])
def test_lane_groups_divide_the_lanes(lw, want):
    """Each level's groups divide what is left of a window's lanes, so that
    no group straddles two windows: the largest divisor up to LANE_RADIX,
    else the smallest prime factor."""
    got = msm13.lane_groups(lw)
    assert got == want and int(np.prod(got)) == lw


@pytest.mark.parametrize("n,c,lanes,kind", [(16, 4, 4, "random"), (64, 4, 8, "random"), (64, 4, 8, "0/1"),
                                            (32, 4, 32, "random"), (12, 4, 4096, "random"), (96, 4, 4096, "0/1"),
                                            (16, 16, 16, "random"), (16, 16, 4, "0/1")])
def test_plan_equals_the_plain_window_sums(n, c, lanes, kind):
    """On four windows (the lowest three and the short top one); at c = 4
    also with the reference's lane offsets, word for word; at n = 12 and 96
    a window's 12 and 96 lanes are not a power of two."""
    rng = np.random.default_rng(3 * n + c)
    engine_points = [g1g.random_point(rng) for _ in range(n)]
    if kind == "random":
        engine_points[3] = engine_points[2]  # a repeated base with another scalar
    pts = group.from_affine_ints(engine_points, "cpu")
    engine = msm13.Msm13(pts, c=c, lanes=lanes)
    _, digits = _digits(rng, n, c, kind)
    digits = digits[list(range(3)) + [digits.shape[0] - 1]]  # windows are independent: three and the short top one
    W = digits.shape[0]
    Lw = msm13.geometry(n, c, lanes, W)["Lw"]
    S = n // Lw
    sd, perm = torch.sort(digits, dim=1, stable=True)
    ax, ay = engine.ax13.to(torch.int64), engine.ay13.to(torch.int64)
    px = ax[:, perm.reshape(-1)].reshape(L13, W, Lw * S)
    py = ay[:, perm.reshape(-1)].reshape(L13, W, Lw * S)
    sums = {}
    for radix in ((None, msm13.LANE_RADIX) if c == 4 else (msm13.LANE_RADIX,)):
        want, wflag = msm13._plain_window_sums(px.reshape(L13, W, Lw, S), py.reshape(L13, W, Lw, S), sd, c,
                                               lane_radix=radix)
        got, flag = _plan_window_sums(px, py, sd, c, Lw, S, radix)
        assert got == _records(want)
        assert flag == bool(wflag)
        sums[radix] = (_affine(got), flag)
    golden = []
    for w in range(W):
        acc = None
        for pt, d in zip(engine_points, digits[w].tolist()):
            acc = g1g.add(acc, g1g.scalar_mul(pt, d))
        golden.append(acc)
    for radix, (pts_, flag) in sums.items():
        if not flag:
            assert pts_ == golden
