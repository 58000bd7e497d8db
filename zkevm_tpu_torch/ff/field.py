"""BN254 Fr / Fq arithmetic on torch tensors (kernel A and its plain version).

Port of ``zkevm_tpu/ff/limbs.py``. A field element is a ``(..., 8)``
``torch.int32`` tensor holding the 256-bit little-endian integer as eight
32-bit words (the bit patterns of uint32 words). Elements are kept in
Montgomery form with R = 2^256 and are always canonical (< p): the same
integers as the reference's ``(..., 16)`` arrays of 16-bit limbs, so the
two layouts convert by repacking (``zkevm_tpu_torch.convert``).

Every public operation broadcasts over leading dimensions. On a CUDA tensor
it launches the hand-written kernel in ``csrc/field.cu``; on a CPU tensor
it runs the plain PyTorch version below, which computes on 16-bit limbs held
in int64 (CPU ``torch.uint32`` has no add or shift, and int64 cannot hold a
32x32-bit product plus a carry).
"""

from __future__ import annotations

import ctypes
import dataclasses
from functools import lru_cache

import numpy as np
import torch

from zkevm_tpu_torch import kernels
from zkevm_tpu_torch.ff import goldens

W = 8  # 32-bit words per element
MASK16 = 0xFFFF
MASK32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Host conversions: python ints <-> (..., 8) word arrays
# ---------------------------------------------------------------------------

def words_from_ints(xs) -> np.ndarray:
    """Iterable of ints in [0, 2^256) -> (N, 8) uint32 words."""
    xs = list(xs)
    raw = b"".join(int(x).to_bytes(32, "little") for x in xs)
    return np.frombuffer(raw, dtype="<u4").reshape(len(xs), W).astype(np.uint32)


def ints_from_words(a) -> list[int]:
    """(..., 8) words (numpy or tensor) -> flat list of ints."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32)).reshape(-1, W)
    raw = a.astype("<u4").tobytes()
    return [int.from_bytes(raw[32 * i : 32 * i + 32], "little") for i in range(a.shape[0])]


def words_from_limbs16(a) -> np.ndarray:
    """(..., 16) 16-bit limbs (the reference's layout) -> (..., 8) uint32 words."""
    a = np.asarray(a, dtype=np.uint32)
    pairs = a.reshape(*a.shape[:-1], W, 2)
    return (pairs[..., 0] | (pairs[..., 1] << 16)).astype(np.uint32)


def to_words(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> uint32 numpy words on the host (same bits)."""
    return np.ascontiguousarray(t.detach().cpu().numpy()).view(np.uint32)


def to_tensor(words: np.ndarray, device) -> torch.Tensor:
    """uint32 words -> int32 tensor on ``device`` (same bits)."""
    arr = np.ascontiguousarray(np.asarray(words, dtype=np.uint32)).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    name: str
    modulus: int
    field_id: int  # the kernel's field selector: 0 = Fr, 1 = Fq

    @property
    def r(self) -> int:
        return (1 << 256) % self.modulus

    @property
    def r2(self) -> int:
        return self.r * self.r % self.modulus

    @property
    def ninv16(self) -> int:
        return (-pow(self.modulus, -1, 1 << 16)) % (1 << 16)

    def encode(self, x: int) -> np.ndarray:
        """int -> (8,) Montgomery words (host)."""
        return words_from_ints([(x % self.modulus) * self.r % self.modulus])[0]

    def encode_many(self, xs) -> np.ndarray:
        return words_from_ints([(x % self.modulus) * self.r % self.modulus for x in xs])

    def decode(self, a) -> int:
        return self.decode_many(a)[0]

    def decode_many(self, a) -> list[int]:
        rinv = pow(self.r, -1, self.modulus)
        return [v * rinv % self.modulus for v in ints_from_words(a)]

    def const(self, x: int, device) -> torch.Tensor:
        """(8,) Montgomery tensor of x on ``device`` (cached)."""
        return _const(self, x % self.modulus, str(torch.device(device)))

    def mont_one(self, device) -> torch.Tensor:
        return self.const(1, device)


@lru_cache(maxsize=4096)
def _const(spec: FieldSpec, x: int, device: str) -> torch.Tensor:
    return to_tensor(spec.encode(x), device)


@lru_cache(maxsize=64)
def _raw(value: int, device: str) -> torch.Tensor:
    """(8,) tensor of a raw (non-Montgomery) integer."""
    return to_tensor(words_from_ints([value])[0], device)


FR = FieldSpec("Fr", goldens.FR_MOD, 0)
FQ = FieldSpec("Fq", goldens.FQ_MOD, 1)


# ---------------------------------------------------------------------------
# Plain PyTorch version (16-bit limbs in int64)
# ---------------------------------------------------------------------------

def _to16(a: torch.Tensor) -> torch.Tensor:
    w = a.to(torch.int64) & MASK32
    return torch.stack([w & MASK16, w >> 16], dim=-1).reshape(*a.shape[:-1], 16)


def _to32(a: torch.Tensor) -> torch.Tensor:
    return a.to(torch.int64) & MASK32


def _from32(w: torch.Tensor) -> torch.Tensor:
    return (w - ((w >> 31) << 32)).to(torch.int32)


@lru_cache(maxsize=16)
def _p_words64(spec: FieldSpec, device: str) -> torch.Tensor:
    return torch.tensor([(spec.modulus >> (32 * i)) & MASK32 for i in range(W)],
                        dtype=torch.int64, device=device)


@lru_cache(maxsize=16)
def _p_limbs64(spec: FieldSpec, device: str) -> torch.Tensor:
    return torch.tensor([(spec.modulus >> (16 * i)) & MASK16 for i in range(16)],
                        dtype=torch.int64, device=device)


def _ripple(rows: list, bits: int) -> tuple[list, torch.Tensor]:
    """Carry-propagate a list of non-negative int64 rows of ``bits``-bit
    positions -> (normalised rows, carry out)."""
    mask = (1 << bits) - 1
    out = []
    carry = torch.zeros_like(rows[0])
    for r in rows:
        v = r + carry
        out.append(v & mask)
        carry = v >> bits
    return out, carry


def _cond_sub_p(spec: FieldSpec, w: torch.Tensor) -> torch.Tensor:
    """(..., 8) int64 words with value < 2p -> value mod p."""
    p = _p_words64(spec, str(w.device))
    d = w - p
    rows, borrow = [], torch.zeros_like(w[..., 0])
    for i in range(W):
        v = d[..., i] - borrow
        borrow = (v < 0).to(torch.int64)
        rows.append(v + (borrow << 32))
    keep = (borrow != 0)[..., None]
    return torch.where(keep, w, torch.stack(rows, dim=-1))


def _plain_add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    s = _to32(a) + _to32(b)
    rows, _ = _ripple(list(s.unbind(-1)), 32)
    return _from32(_cond_sub_p(spec, torch.stack(rows, dim=-1)))


def _plain_sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = _to32(a) - _to32(b)
    rows, borrow = [], torch.zeros_like(d[..., 0])
    for i in range(W):
        v = d[..., i] - borrow
        borrow = (v < 0).to(torch.int64)
        rows.append(v + (borrow << 32))
    diff = torch.stack(rows, dim=-1)
    p = _p_words64(spec, str(d.device))
    added, _ = _ripple(list((diff + p).unbind(-1)), 32)
    under = (borrow != 0)[..., None]
    return _from32(torch.where(under, torch.stack(added, dim=-1), diff))


def _plain_mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product over 16-bit limbs in int64: column i of the
    32-column accumulator gains a_i * b and m_i * p, then pushes its carry
    up. Every column stays below 2^38 (at most two products < 2^32 per
    step, 16 steps), so int64 never overflows."""
    a16, b16 = torch.broadcast_tensors(_to16(a), _to16(b))
    p = _p_limbs64(spec, str(a16.device))
    ninv = spec.ninv16
    t = torch.zeros(*a16.shape[:-1], 32, dtype=torch.int64, device=a16.device)
    for i in range(16):
        window = t[..., i : i + 16]
        window.addcmul_(a16[..., i : i + 1], b16)
        m = ((t[..., i] & MASK16) * ninv) & MASK16
        window.addcmul_(m[..., None], p)
        t[..., i + 1] += t[..., i] >> 16
    hi = t[..., 16:]  # the result, < 2p, in 16 lazy columns
    rows, _ = _ripple(list((hi[..., 0::2] + (hi[..., 1::2] << 16)).unbind(-1)), 32)
    return _from32(_cond_sub_p(spec, torch.stack(rows, dim=-1)))


def _plain_pow(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    acc = spec.mont_one(a.device).expand(a.shape).clone()
    for bit in range(e.bit_length() - 1, -1, -1):
        acc = _plain_mont_mul(spec, acc, acc)
        if (e >> bit) & 1:
            acc = _plain_mont_mul(spec, acc, a)
    return acc


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

_OPS = {"add": 0, "sub": 1, "mul": 2, "neg": 3}


def _layout(shape: tuple, x: torch.Tensor) -> list[int]:
    """Element strides of ``x`` broadcast to ``shape`` (0 on broadcast
    and size-1 dimensions)."""
    st = x.expand(*shape, W).stride()[:-1]
    return [s // W if d > 1 else 0 for s, d in zip(st, shape)]


def _collapse(shape: tuple, strides: list[list[int]]) -> tuple[list[int], list[list[int]]]:
    """Merge adjacent batch dims that are contiguous for every operand, so
    that any broadcast the port uses fits the kernel's 4 dims."""
    dims = [d for d in shape]
    sts = [list(s) for s in strides]
    i = len(dims) - 1
    while i > 0:
        if all(s[i - 1] == s[i] * dims[i] for s in sts):
            dims[i - 1] *= dims[i]
            del dims[i]
            for s in sts:
                s[i - 1] = s[i]
                del s[i]
        i -= 1
    if len(dims) > 4:
        raise ValueError(f"field op: broadcast shape {shape} needs more than 4 dims")
    pad = 4 - len(dims)
    return [1] * pad + dims, [[0] * pad + s for s in sts]


def _check_operand(name: str, x: torch.Tensor) -> None:
    """The kernel reads any layout whose elements are 8 contiguous words
    at whole-element strides (slices and broadcasts included)."""
    if x.device.type != "cuda" or x.dtype != torch.int32 or x.dim() == 0 or x.shape[-1] != W:
        raise ValueError(f"field op {name}: expected a CUDA int32 (..., 8) tensor, got "
                         f"{x.device} {x.dtype} {tuple(x.shape)}")
    if x.stride(-1) != 1 or any(s % W for s, d in zip(x.stride()[:-1], x.shape[:-1]) if d > 1):
        raise ValueError(f"field op {name}: elements must be 8 contiguous words, strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError(f"field op {name}: data pointer not 16-byte aligned")


def _launch_binary(spec: FieldSpec, op: str, a: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    _check_operand("a", a)
    if b is None:
        shape = tuple(a.shape[:-1])
        b = a
    else:
        _check_operand("b", b)
        if b.device != a.device:
            raise ValueError("field op: operands on different devices")
        shape = tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    out = torch.empty(*shape, W, dtype=torch.int32, device=a.device)
    n = out.numel() // W
    if n == 0:
        return out
    dims, (sa, sb) = _collapse(shape, [_layout(shape, a), _layout(shape, b)])
    meta = (ctypes.c_longlong * 12)(*dims, *sa, *sb)
    kernel = "field_mul" if op == "mul" else "field_add_sub"
    kernels.launch(kernel, "field", "zk_field_binary", spec.field_id, _OPS[op],
                   out.data_ptr(), a.data_ptr(), b.data_ptr(), ctypes.addressof(meta), n)
    return out


def _launch_pow(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    _check_operand("a", a)
    if not 0 <= e < (1 << 256):
        raise ValueError("pow: exponent must be in [0, 2^256)")
    out = torch.empty_like(a)
    n = a.numel() // W
    if n == 0:
        return out
    exp = (ctypes.c_uint32 * 8)(*[(e >> (32 * i)) & MASK32 for i in range(8)])
    kernels.launch("field_pow", "field", "zk_field_pow", spec.field_id, out.data_ptr(),
                   a.data_ptr(), ctypes.addressof(exp), e.bit_length(), n)
    return out


def _on_cpu(*xs) -> bool:
    """True for CPU operands (the plain version), False for CUDA ones (the
    kernel); raises on anything else."""
    for x in xs:
        if x.dtype != torch.int32 or x.dim() == 0 or x.shape[-1] != W:
            raise ValueError(f"field op: expected int32 (..., 8), got {x.dtype} {tuple(x.shape)}")
    devs = {x.device.type for x in xs}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"field op: unsupported devices {devs}")


# ---------------------------------------------------------------------------
# Public field ops (Montgomery in, Montgomery out)
# ---------------------------------------------------------------------------

def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _on_cpu(a, b):
        return _plain_add(spec, a, b)
    return _launch_binary(spec, "add", a, b)


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _on_cpu(a, b):
        return _plain_sub(spec, a, b)
    return _launch_binary(spec, "sub", a, b)


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    if _on_cpu(a):
        return _plain_sub(spec, torch.zeros_like(a), a)
    return _launch_binary(spec, "neg", a, None)


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a * b * 2^-256) mod p."""
    if _on_cpu(a, b):
        return _plain_mont_mul(spec, a, b)
    return _launch_binary(spec, "mul", a, b)


def sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, a)


def to_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, _raw(spec.r2, str(a.device)))


def from_mont(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, a, _raw(1, str(a.device)))


def pow_const(spec: FieldSpec, a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a host-known exponent."""
    if _on_cpu(a):
        return _plain_pow(spec, a, e)
    return _launch_pow(spec, a.contiguous(), e)  # the kernel reads elements 8 words apart


def inv(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Fermat inversion, elementwise; inv(0) = 0."""
    return pow_const(spec, a, spec.modulus - 2)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


def _plain_nonzero(a: torch.Tensor) -> torch.Tensor:
    """(..., 8) words -> (...) bool, True where the element is not zero: the
    OR of the eight words, as kernel F folds them."""
    w = a.to(torch.int64)
    acc = w[..., 0]
    for i in range(1, W):
        acc = acc | w[..., i]
    return acc != 0


def nonzero(a: torch.Tensor) -> torch.Tensor:
    """(..., 8) field elements -> (...) bool flags, True where not zero
    (kernel F on a CUDA tensor: one byte read back per element)."""
    if _on_cpu(a):
        return _plain_nonzero(a)
    a = a.contiguous()
    out = torch.empty(a.shape[:-1], dtype=torch.bool, device=a.device)
    n = out.numel()
    if n:
        _check_operand("a", a)
        kernels.launch("field_nonzero", "field", "zk_field_nonzero", out.data_ptr(), a.data_ptr(), n)
    return out


def sum_rows(spec: FieldSpec, a: torch.Tensor, dim: int) -> torch.Tensor:
    """Field sum along ``dim`` (keeps no dim) by a halving tree of adds,
    padding with zeros (the additive identity) to a power of two."""
    a = a.movedim(dim, 0)
    m = 1
    while m < a.shape[0]:
        m *= 2
    if m != a.shape[0]:
        a = torch.cat([a, a.new_zeros((m - a.shape[0],) + tuple(a.shape[1:]))])
    while m > 1:
        m //= 2
        a = add(spec, a[:m], a[m:])
    return a[0]


def prefix_product(spec: FieldSpec, factors: torch.Tensor) -> torch.Tensor:
    """(n, 8) Montgomery factors -> exclusive prefix products (z[0] = 1).

    A log-step (Hillis-Steele) scan: log2(n) launches of the Montgomery
    product, the counterpart of the reference's associative_scan."""
    x = factors
    n = x.shape[0]
    shift = 1
    while shift < n:
        x = torch.cat([x[:shift], mont_mul(spec, x[shift:], x[: n - shift])])
        shift *= 2
    return torch.cat([spec.mont_one(x.device)[None], x[:-1]])


# ---------------------------------------------------------------------------
# Kernel comparisons and tests: the plain version on any device
# ---------------------------------------------------------------------------

PLAIN = {
    "add": _plain_add,
    "sub": _plain_sub,
    "mul": _plain_mont_mul,
    "pow": _plain_pow,
    "nonzero": _plain_nonzero,
}
