"""Lazy 13-bit-limb prime field on torch tensors (kernel J and its plain version).

Port of ``zkevm_tpu/ff/lazy13.py``. An element is a ``(21, ...)`` tensor of
little-endian 13-bit limbs, limbs first and the batch on the trailing axes,
in standard form (no Montgomery factor). Values are lazy: only congruent to
the intended value mod p, with value < 2^263 and limbs < 2^13 + 2^6. A
product is 441 schoolbook limb products summed into 41 columns (< 2^31);
the columns are split into 164 bytes and reduced mod p by one constant
u8 matrix product, (42, 164 t) @ (164 t, N), where the t <= 4 terms of a
``combine_reduce`` fold signed scales into the matrix; two carry rounds and
a fold of the top limb through 2^262 mod p follow. Equality and zero tests
need ``canon13`` / ``is_zero13`` (a Barrett step, a ripple and conditional
subtractions).

The public tensors are int32 (limbs are below 2^15). On a CUDA tensor every
operation launches kernel J (``csrc/lazy13.cu``, reduction on the int8
tensor cores); on a CPU tensor the plain PyTorch version below runs, in
int64 with u32 wrap-around emulated where the reference could wrap. Both
give the reference's lazy words word for word: everything is exact integer
arithmetic. The plain reduction is a float64 matrix product (exact: every
sum is below 2^31), since torch has no integer matrix product on CUDA.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from zkevm_tpu_torch import kernels
from zkevm_tpu_torch.ff import field as ff

L13 = 21  # limbs per element (273-bit capacity)
B13 = 13  # bits per limb
M13 = (1 << B13) - 1
NPROD = 2 * L13 - 1  # 41 product columns
NBYTES = 4  # bytes per product column (columns < 2^31)
NROWS = NPROD * NBYTES  # 164 rows of the reduction matrix per term
MASK32 = 0xFFFFFFFF
MAX_TERMS = 4

# kernel J's tensor-core tiling of the reduction (csrc/lazy13.cuh): the
# (42, 164) matrix padded to 48 rows (3 m16 tiles) and 192 columns (6 k32
# steps), in mma.m16n8k32 A-fragment order: [tile][step][lane][4 words]
MMA_TILES, MMA_STEPS = 3, 6
FIELD_WORDS = 12 * L13 + 2  # csrc/lazy13.cuh struct l13::Field


def _limbs13(x: int) -> np.ndarray:
    return np.array([(x >> (B13 * i)) & M13 for i in range(L13)], dtype=np.int64)


class Lazy13:
    """Per-field constants, the reference's ``Lazy13``: the (42, 164) u8
    reduction matrix ``C`` (rows byte-plane-major: row k*41 + j is byte k of
    product column j), ``w262`` = 2^262 mod p, the borrow-absorbed multiple
    of p ``kp_t`` that ``sub13`` adds, the strict limbs of that multiple
    ``kp_limbs``, ``p_limbs13`` and the Barrett constant ``mu``."""

    def __init__(self, spec: ff.FieldSpec):
        self.spec = spec
        p = spec.modulus
        self.p = p
        assert p < (1 << 254)
        C = np.zeros((NROWS, 2 * L13), dtype=np.uint8)
        for j in range(NPROD):
            for k in range(NBYTES):
                w = pow(2, B13 * j + 8 * k, p)
                for i in range(L13):
                    limb = (w >> (B13 * i)) & M13
                    C[k * NPROD + j, 2 * i] = limb & 0xFF
                    C[k * NPROD + j, 2 * i + 1] = limb >> 8
        self.C = np.ascontiguousarray(C.T)  # (42, 164)
        self.w262 = _limbs13(pow(2, 262, p))
        self.m_kp = (1 << 265) // p + 1
        kp = self.m_kp * p
        kpl = [(kp >> (B13 * i)) & M13 for i in range(L13)]
        kpt = list(kpl)
        kpt[0] += 1 << 14
        for i in range(1, L13 - 1):
            kpt[i] += (1 << 14) - 2
        kpt[L13 - 1] -= 2
        assert kpt[L13 - 1] >= 28 and all(v >= (1 << 14) - 2 for v in kpt[:-1])
        assert sum(v << (B13 * i) for i, v in enumerate(kpt)) == kp
        self.kp_t = np.array(kpt, dtype=np.int64)
        self.kp_limbs = np.array(kpl, dtype=np.int64)
        self.p_limbs13 = _limbs13(p)
        self.mu_k = 20
        self.mu = (1 << (247 + self.mu_k)) // p
        assert self.mu < (1 << 16)
        # KP + i*p for i < 8: the strict patterns of a zero after the Barrett step
        self.zero_patterns = np.stack([_limbs13((self.m_kp + i) * p) for i in range(8)])

    # --- host conversions (ints <-> (21,) / (21, N) limbs) ---------------

    def from_int(self, x: int) -> np.ndarray:
        return _limbs13(x % self.p)

    def to_int(self, a) -> int:
        a = _host(a).reshape(L13)
        return sum(int(a[i]) << (B13 * i) for i in range(L13)) % self.p

    def from_ints(self, xs) -> np.ndarray:
        """ints -> (21, N) int64."""
        return np.stack([self.from_int(x) for x in xs], axis=1)

    def to_ints(self, a) -> list[int]:
        a = _host(a).reshape(L13, -1)
        return [sum(int(a[i, j]) << (B13 * i) for i in range(L13)) % self.p for j in range(a.shape[1])]

    def tensor(self, xs, device) -> torch.Tensor:
        """ints -> (21, N) int32 tensor on ``device``."""
        return torch.from_numpy(self.from_ints(xs).astype(np.int32)).to(device)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a).astype(np.int64)


@lru_cache(maxsize=None)
def _ctx(spec: ff.FieldSpec) -> Lazy13:
    return Lazy13(spec)


def ctx_fq() -> Lazy13:
    return _ctx(ff.FQ)


def ctx_fr() -> Lazy13:
    return _ctx(ff.FR)


@lru_cache(maxsize=None)
def _scaled_C(lz: Lazy13, scales: tuple) -> np.ndarray:
    """Reduction matrix of a signed-scaled combined reduction: block s has
    the weights scales[s] * 2^w mod p (the reference's ``_scaled_C``)."""
    p = lz.p
    C = np.zeros((NROWS * len(scales), 2 * L13), dtype=np.uint8)
    for s, k in enumerate(scales):
        for j in range(NPROD):
            for kk in range(NBYTES):
                w = (k * pow(2, B13 * j + 8 * kk, p)) % p
                for i in range(L13):
                    limb = (w >> (B13 * i)) & M13
                    C[s * NROWS + kk * NPROD + j, 2 * i] = limb & 0xFF
                    C[s * NROWS + kk * NPROD + j, 2 * i + 1] = limb >> 8
    return np.ascontiguousarray(C.T)


# ---------------------------------------------------------------------------
# Plain PyTorch version: (21, ...) int64 limb tensors
# ---------------------------------------------------------------------------

@lru_cache(maxsize=16)
def _consts(lz: Lazy13, device: str) -> dict:
    """The field's constants as int64 tensors on ``device``: limb columns
    (21, 1) and the eight zero patterns (8, 21, 1)."""
    def col(v):
        return torch.tensor([int(x) for x in v], dtype=torch.int64, device=device)[:, None]

    return {"w262": col(lz.w262), "kp_t": col(lz.kp_t), "kp_limbs": col(lz.kp_limbs), "p": col(lz.p_limbs13),
            "zeros": torch.from_numpy(lz.zero_patterns).to(device)[:, :, None],
            "weights": col([1 << i for i in range(L13)])}


@lru_cache(maxsize=8)
def _diag(device: str) -> torch.Tensor:
    """Column i + j of each of the 441 limb products a_i b_j."""
    return torch.tensor([i + j for i in range(L13) for j in range(L13)], dtype=torch.int64, device=device)


@lru_cache(maxsize=64)
def _matrix(lz: Lazy13, scales: tuple, device: str) -> torch.Tensor:
    """The reduction matrix of ``scales`` folded to limbs, (21, 164 t): its
    rows are lo + 256 hi of the (42, 164 t) u8 matrix (the reference adds
    them after its product), its columns in the bytes' little-endian order,
    k' = 4 (s 41 + j) + byte. float64: exact, every sum is below 2^31, and
    torch has no integer matrix product on CUDA."""
    c = _scaled_C(lz, scales).astype(np.int64)  # (42, t * 164): [row, s*164 + byte*41 + j]
    t = len(scales)
    c = c.reshape(2 * L13, t, NBYTES, NPROD).transpose(0, 1, 3, 2).reshape(2 * L13, t * NROWS)
    folded = c[0::2] + (c[1::2] << 8)
    return torch.from_numpy(folded).to(device=device, dtype=torch.float64)


def _flat(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0], -1)


def _p_prod_T(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(21, B) x (21, B) -> (41, B) schoolbook columns (each below 2^31)."""
    outer = (a[:, None, :] * b[None, :, :]).reshape(L13 * L13, -1)
    out = torch.zeros(NPROD, outer.shape[1], dtype=torch.int64, device=a.device)
    return out.index_add_(0, _diag(str(a.device)), outer)


def _p_round(r: torch.Tensor) -> torch.Tensor:
    """One carry round on (21, B) or (g, 21, B) limbs; the top carry is
    dropped. (Explicit indices: this runs ~10^4 times a toy proof.)"""
    hi = r >> B13
    out = r & M13
    if r.dim() == 2:
        out[1:].add_(hi[:-1])
    else:
        out[:, 1:].add_(hi[:, :-1])
    return out


def _p_fold_top(lz: Lazy13, r: torch.Tensor) -> torch.Tensor:
    """Limb 20 keeps its low 2 bits; the rest folds back through 2^262 mod p
    (``r`` is a fresh tensor, updated in place)."""
    top = r[20] if r.dim() == 2 else r[:, 20]
    e = top >> 2
    top &= 3
    return r.add_(e.unsqueeze(-2) * _consts(lz, str(r.device))["w262"])


def _p_carry_fold(lz: Lazy13, r: torch.Tensor) -> torch.Tensor:
    r = _p_round(_p_round(r))
    return _p_round(_p_round(_p_fold_top(lz, r)))


def _p_bytes(t: torch.Tensor) -> torch.Tensor:
    """(..., 41 t, B) product columns -> (..., 164 t, B) bytes, each
    column's four bytes little-endian in a row."""
    v = t.to(torch.int32).transpose(-1, -2).contiguous().view(torch.uint8)
    return v.transpose(-1, -2)


def _p_reduce_many(lz: Lazy13, groups) -> list:
    """One reduction per group of terms [(T (41, B) int64, scale)], groups
    with the same number of terms as one batched matrix product: sum_k
    scale_k * value(T_k) mod p for each -> list of (21, B)."""
    out = [None] * len(groups)
    by_len: dict = {}
    for i, terms in enumerate(groups):
        by_len.setdefault(len(terms), []).append(i)
    for idx in by_len.values():
        dev = str(groups[idx[0]][0][0].device)
        mats = [_matrix(lz, tuple(int(s) for _, s in groups[i]), dev) for i in idx]
        x = torch.stack([torch.cat([t for t, _ in groups[i]]) for i in idx])  # (g, 41 t, B)
        r = torch.bmm(torch.stack(mats), _p_bytes(x).to(mats[0].dtype)).to(torch.int64)  # (g, 21, B)
        r = _p_carry_fold(lz, r)
        for k, i in enumerate(idx):
            out[i] = r[k]
    return out


def _p_reduce(lz: Lazy13, terms) -> torch.Tensor:
    """sum_k scale_k * value(T_k) mod p for [(T (41, B) int64, scale)]."""
    return _p_reduce_many(lz, [terms])[0]


def _p_lazy_add(lz: Lazy13, t: torch.Tensor) -> torch.Tensor:
    return _p_round(_p_fold_top(lz, _p_round(t & MASK32)))


def _p_add(lz: Lazy13, a, b):
    return _p_lazy_add(lz, a + b)


def _p_sub(lz: Lazy13, a, b):
    return _p_lazy_add(lz, a + _consts(lz, str(a.device))["kp_t"] - b)


def _p_mul(lz: Lazy13, a, b):
    return _p_reduce(lz, [(_p_prod_T(a, b), 1)])


def _p_sqr(lz: Lazy13, a):
    return _p_reduce(lz, [(_p_prod_T(a, a), 1)])


def _p_normalize(t: torch.Tensor) -> torch.Tensor:
    """Strict 13-bit limbs of (sum t_l 2^(13 l)) mod 2^273 for any int64
    limbs (negative ones too): carry rounds until no carry is left. The
    same words as the reference's sequential ripples, whose final carry or
    borrow is dropped."""
    while True:
        hi = t >> B13
        if not bool(hi[:-1].any()):
            return t & M13
        t = t & M13
        t[1:] += hi[:-1]


def _p_barrett_sub(lz: Lazy13, a: torch.Tensor) -> torch.Tensor:
    """Strict limbs of V - m p + KP (V the exact value of a), in [KP, KP + 7p)."""
    k = _consts(lz, str(a.device))
    v_hi = (a[19] + (a[20] << B13)) & MASK32
    m = ((v_hi * lz.mu) & MASK32) >> lz.mu_k
    mp = _p_round(_p_round((m[None] * k["p"]) & MASK32))
    return _p_normalize((a + k["kp_t"] - mp) & MASK32)


def _p_canon(lz: Lazy13, a):
    k = _consts(lz, str(a.device))
    t = _p_normalize(_p_barrett_sub(lz, a) - k["kp_limbs"])
    for _ in range(7):
        # t < p by the sign of the highest limb that differs
        less = (torch.sign(t - k["p"]) * k["weights"]).sum(0) < 0
        t = torch.where(less[None], t, _p_normalize(t - k["p"]))
    return t


def _p_is_zero(lz: Lazy13, a) -> torch.Tensor:
    t = _p_barrett_sub(lz, a)
    return (t[None] == _consts(lz, str(a.device))["zeros"]).all(1).any(0)


def _p_from_words(words: torch.Tensor) -> torch.Tensor:
    """(B, 8) standard-form words -> (21, B) limbs (bits >= 256 are zero)."""
    w = words.to(torch.int64) & MASK32
    out = []
    for i in range(L13):
        j, off = divmod(B13 * i, 32)
        if j >= ff.W:
            out.append(torch.zeros_like(w[:, 0]))
            continue
        v = w[:, j] >> off
        if off + B13 > 32 and j + 1 < ff.W:
            v = v | (w[:, j + 1] << (32 - off))
        out.append(v & M13)
    return torch.stack(out)


def _p_to_words(a: torch.Tensor) -> torch.Tensor:
    """(21, B) strict limbs -> (B, 8) int32 words of the value mod 2^256."""
    words = []
    for j in range(ff.W):
        v = torch.zeros_like(a[0])
        for i in range(L13):
            shift = B13 * i - 32 * j
            if -B13 < shift < 32:
                v = v | ((a[i] << shift) if shift >= 0 else (a[i] >> -shift))
        words.append(v & MASK32)
    return ff._from32(torch.stack(words, dim=-1))


# ---------------------------------------------------------------------------
# Kernel J launches
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def field_struct(lz: Lazy13):
    """The host image of csrc/lazy13.cuh ``l13::Field`` (passed by value)."""
    vals = [*lz.p_limbs13, *lz.w262, *lz.kp_t, *lz.kp_limbs, *lz.zero_patterns.reshape(-1), lz.mu, lz.mu_k]
    assert len(vals) == FIELD_WORDS
    return (ctypes.c_uint32 * FIELD_WORDS)(*[int(v) for v in vals])


def fragment_matrix(lz: Lazy13, scale: int) -> np.ndarray:
    """The (42, 164) reduction matrix of one scale in kernel J's order: its
    K axis permuted to k' = 4 j + byte (so that a product column's u32 word
    is its own four K entries), padded to (48, 192), cut into
    mma.m16n8k32 A fragments: (3 tiles, 6 steps, 32 lanes, 4 u32)."""
    ct = _scaled_C(lz, (int(scale),))  # (42, 164): [row, byte * 41 + j]
    a = np.zeros((16 * MMA_TILES, 32 * MMA_STEPS), dtype=np.uint8)
    for kk in range(NBYTES):
        a[: 2 * L13, kk : 4 * NPROD : 4] = ct[:, kk * NPROD : (kk + 1) * NPROD]
    out = np.zeros((MMA_TILES, MMA_STEPS, 32, 4), dtype=np.uint32)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 16), (8, 16))):
            for m in range(MMA_TILES):
                for s in range(MMA_STEPS):
                    b = a[16 * m + g + dr, 32 * s + dk + 4 * t : 32 * s + dk + 4 * t + 4]
                    out[m, s, lane, reg] = int.from_bytes(b.tobytes(), "little")
    return out


@lru_cache(maxsize=64)
def device_matrix(lz: Lazy13, scale: int, device: str) -> torch.Tensor:
    return ff.to_tensor(fragment_matrix(lz, scale).reshape(-1), device)


def _check(name: str, t: torch.Tensor, rows: int) -> None:
    if t.device.type != "cuda" or t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"lazy13 {name}: expected a CUDA int32 ({rows}, n) tensor, got "
                         f"{t.device} {t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"lazy13 {name}: expected a contiguous tensor")


_BINARY = {"mul": 0, "sqr": 1, "add": 2, "sub": 3}


def _launch_binary(lz: Lazy13, op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    n = a.shape[1]
    out = torch.empty_like(a)
    if n:
        _check("a", a, L13)
        _check("b", b, L13)
        mat = device_matrix(lz, 1, str(a.device))
        kernels.launch("lazy13", "lazy13", "zk_l13_binary", ctypes.addressof(field_struct(lz)),
                       mat.data_ptr(), _BINARY[op], out.data_ptr(), a.data_ptr(), b.data_ptr(), n)
    return out


def _launch_unary(symbol: str, lz: Lazy13, a: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    if a.shape[1]:
        _check("a", a, L13)
        kernels.launch("lazy13", "lazy13", symbol, ctypes.addressof(field_struct(lz)), out.data_ptr(),
                       a.data_ptr(), a.shape[1])
    return out


def _launch_prod_T(a: torch.Tensor, b: torch.Tensor, square: bool) -> torch.Tensor:
    n = a.shape[1]
    out = torch.empty(NPROD, n, dtype=torch.int32, device=a.device)
    if n:
        _check("a", a, L13)
        _check("b", b, L13)
        kernels.launch("lazy13", "lazy13", "zk_l13_prod_T", out.data_ptr(), a.data_ptr(), b.data_ptr(),
                       int(square), n)
    return out


def _launch_combine(lz: Lazy13, terms) -> torch.Tensor:
    n = terms[0][0].shape[1]
    dev = terms[0][0].device
    out = torch.empty(L13, n, dtype=torch.int32, device=dev)
    if n:
        ptrs = (ctypes.c_uint64 * (2 * MAX_TERMS))()
        for k, (t, s) in enumerate(terms):
            _check(f"term {k}", t, NPROD)
            if t.shape[1] != n or t.device != dev:
                raise ValueError("lazy13 combine_reduce: terms of different sizes or devices")
            ptrs[k] = t.data_ptr()
            ptrs[MAX_TERMS + k] = device_matrix(lz, int(s), str(dev)).data_ptr()
        kernels.launch("lazy13", "lazy13", "zk_l13_combine", ctypes.addressof(field_struct(lz)),
                       out.data_ptr(), ctypes.addressof(ptrs), len(terms), n)
    return out


# ---------------------------------------------------------------------------
# Public operations: (21, ...) int32 in, (21, ...) int32 out
# ---------------------------------------------------------------------------

def _on_cpu(*xs) -> bool:
    for x in xs:
        if x.dim() == 0 or x.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"lazy13: expected an integer (limbs, ...) tensor, got {x.dtype} {tuple(x.shape)}")
    devs = {x.device.type for x in xs}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"lazy13: unsupported devices {devs}")


def _operands(*xs):
    """Broadcast the batch axes (all but the leading limb axis) and flatten:
    -> (batch shape, [(rows, n) tensors])."""
    batch = torch.broadcast_shapes(*[tuple(x.shape[1:]) for x in xs])
    out = []
    for x in xs:
        x = x.reshape(x.shape[0], *([1] * (len(batch) - (x.dim() - 1))), *x.shape[1:])
        out.append(x.expand(x.shape[0], *batch).reshape(x.shape[0], -1))
    return batch, out


def _plain_out(t: torch.Tensor, rows: int, batch) -> torch.Tensor:
    return t.to(torch.int32).reshape(rows, *batch)


def _cuda_in(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).contiguous()


def prod_T(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(21, ...) x (21, ...) -> (41, ...) product columns."""
    batch, (a2, b2) = _operands(a, b)
    if _on_cpu(a, b):
        return _plain_out(_p_prod_T(a2.to(torch.int64), b2.to(torch.int64)), NPROD, batch)
    return _launch_prod_T(_cuda_in(a2), _cuda_in(b2), False).reshape(NPROD, *batch)


def sqr_T(a: torch.Tensor) -> torch.Tensor:
    """(21, ...) -> (41, ...) square columns (the same integers as prod_T(a, a))."""
    batch, (a2,) = _operands(a)
    if _on_cpu(a):
        a64 = a2.to(torch.int64)
        return _plain_out(_p_prod_T(a64, a64), NPROD, batch)
    a2 = _cuda_in(a2)
    return _launch_prod_T(a2, a2, True).reshape(NPROD, *batch)


def combine_reduce(lz: Lazy13, terms) -> torch.Tensor:
    """One reduction of sum_k scale_k * value(T_k) mod p; terms are
    [(T (41, ...), int scale)], 1 to 4 of them, scales of any sign."""
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"combine_reduce: 1 to {MAX_TERMS} terms, got {len(terms)}")
    batch, ts = _operands(*[t for t, _ in terms])
    if _on_cpu(*[t for t, _ in terms]):
        return _plain_out(_p_reduce(lz, [(t.to(torch.int64), s) for t, (_, s) in zip(ts, terms)]), L13, batch)
    return _launch_combine(lz, [(_cuda_in(t), s) for t, (_, s) in zip(ts, terms)]).reshape(L13, *batch)


def _binary(lz: Lazy13, op: str, a, b, plain):
    batch, (a2, b2) = _operands(a, b)
    if _on_cpu(a, b):
        return _plain_out(plain(lz, a2.to(torch.int64), b2.to(torch.int64)), L13, batch)
    return _launch_binary(lz, op, _cuda_in(a2), _cuda_in(b2)).reshape(L13, *batch)


def mul13(lz: Lazy13, a, b):
    """Lazy modular product; output value < 2^263."""
    return _binary(lz, "mul", a, b, _p_mul)


def sqr13(lz: Lazy13, a):
    return _binary(lz, "sqr", a, a, lambda lz_, x, _: _p_sqr(lz_, x))


def add13(lz: Lazy13, a, b):
    return _binary(lz, "add", a, b, _p_add)


def sub13(lz: Lazy13, a, b):
    """a - b as a + (KP~ - b): borrow-free for any op-output b."""
    return _binary(lz, "sub", a, b, _p_sub)


def dbl13(lz: Lazy13, a):
    return add13(lz, a, a)


def canon13(lz: Lazy13, a):
    """Lazy value (an op output) -> strict limbs of its residue in [0, p)."""
    batch, (a2,) = _operands(a)
    if _on_cpu(a):
        return _plain_out(_p_canon(lz, a2.to(torch.int64)), L13, batch)
    a2 = _cuda_in(a2)
    return _launch_unary("zk_l13_canon", lz, a2, torch.empty_like(a2)).reshape(L13, *batch)


def is_zero13(lz: Lazy13, a) -> torch.Tensor:
    """Exact zero test mod p -> bool over the batch shape."""
    batch, (a2,) = _operands(a)
    if _on_cpu(a):
        return _p_is_zero(lz, a2.to(torch.int64)).reshape(batch)
    a2 = _cuda_in(a2)
    out = torch.empty(a2.shape[1], dtype=torch.bool, device=a2.device)
    return _launch_unary("zk_l13_is_zero", lz, a2, out).reshape(batch)


def eq13(lz: Lazy13, a, b) -> torch.Tensor:
    return is_zero13(lz, sub13(lz, a, b))


def select13(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise select; cond has the batch shape (no limb axis)."""
    return torch.where(cond[None], a, b)


def from_words(words: torch.Tensor) -> torch.Tensor:
    """(..., 8) standard-form int32 words (the port's field layout, not
    Montgomery) -> (21, ...) strict 13-bit limbs; the reference's
    ``from_u16_t`` on the same integers."""
    if words.dim() < 1 or words.shape[-1] != ff.W:
        raise ValueError(f"from_words: expected (..., 8) words, got {tuple(words.shape)}")
    batch = tuple(words.shape[:-1])
    flat = words.reshape(-1, ff.W)
    if _on_cpu(words):
        return _plain_out(_p_from_words(flat), L13, batch)
    flat = _cuda_in(flat)
    out = torch.empty(L13, flat.shape[0], dtype=torch.int32, device=flat.device)
    if flat.shape[0]:
        kernels.check_cuda_tensor("from_words words", flat, torch.int32, ff.W)
        kernels.launch("lazy13", "lazy13", "zk_l13_from_words", out.data_ptr(), flat.data_ptr(), flat.shape[0])
    return out.reshape(L13, *batch)


def to_words(a: torch.Tensor) -> torch.Tensor:
    """(21, ...) strictly canonical limbs (``canon13`` first) -> (..., 8)
    int32 words; the reference's ``to_u16_t`` on the same integers."""
    batch, (a2,) = _operands(a)
    if _on_cpu(a):
        return _p_to_words(a2.to(torch.int64)).reshape(*batch, ff.W)
    a2 = _cuda_in(a2)
    out = torch.empty(a2.shape[1], ff.W, dtype=torch.int32, device=a2.device)
    if a2.shape[1]:
        _check("a", a2, L13)
        kernels.launch("lazy13", "lazy13", "zk_l13_to_words", out.data_ptr(), a2.data_ptr(), a2.shape[1])
    return out.reshape(*batch, ff.W)


def _plain_public(fn):
    """A plain op on int32 (21, B) tensors of any device (the comparisons)."""
    def run(lz, *xs):
        return fn(lz, *[x.to(torch.int64) for x in xs]).to(torch.int32)
    return run


# ---------------------------------------------------------------------------
# Kernel comparisons and tests: the plain version on any device, over
# (rows, B) tensors
# ---------------------------------------------------------------------------

PLAIN = {
    "mul": _plain_public(_p_mul),
    "sqr": _plain_public(_p_sqr),
    "add": _plain_public(_p_add),
    "sub": _plain_public(_p_sub),
    "canon": _plain_public(_p_canon),
    "is_zero": lambda lz, a: _p_is_zero(lz, a.to(torch.int64)),
    "prod_T": lambda a, b: _p_prod_T(a.to(torch.int64), b.to(torch.int64)).to(torch.int32),
    "combine": lambda lz, terms: _p_reduce(lz, [(t.to(torch.int64), s) for t, s in terms]).to(torch.int32),
    "from_words": lambda w: _p_from_words(w).to(torch.int32),
    "to_words": lambda a: _p_to_words(a.to(torch.int64)),
}
