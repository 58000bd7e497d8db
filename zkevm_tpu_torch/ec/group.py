"""BN254 G1 group arithmetic on torch tensors (kernel C and plain version).

Port of ``zkevm_tpu/ec/group.py`` and ``ec/group_t.py``. A batch of points
is a ``(..., 3, 8)`` int32 tensor: Jacobian x, y, z, each a Montgomery Fq
element (``zkevm_tpu_torch.ff.field``); z = 0 encodes the identity.
Formulas are dbl-2009-l and add-2007-bl with complete-case handling, as in
the reference. On CUDA tensors ``add`` and ``scalar_mul`` launch the
kernels in ``csrc/curve.cu``; on CPU tensors the plain versions below run.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from zkevm_tpu_torch import kernels
from zkevm_tpu_torch.device import resolve_device
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FQ

_mul = ff.PLAIN["mul"]
_add = ff.PLAIN["add"]
_sub = ff.PLAIN["sub"]


def identity(batch_shape=(), device=None) -> torch.Tensor:
    """(..., 3, 8) identity points (x = y = 1, z = 0) on ``device`` (CUDA
    unless the caller asks for the CPU)."""
    device = resolve_device(device)
    one = FQ.mont_one(device)
    out = torch.zeros(*batch_shape, 3, ff.W, dtype=torch.int32, device=device)
    out[..., 0, :] = one
    out[..., 1, :] = one
    return out


def from_affine_ints(pts, device=None) -> torch.Tensor:
    """List of (x, y) int pairs (None = identity) -> (N, 3, 8) Jacobian on
    ``device`` (CUDA unless the caller asks for the CPU)."""
    device = resolve_device(device)
    rows = []
    for pt in pts:
        if pt is None:
            rows += [FQ.r, FQ.r, 0]
        else:
            rows += [pt[0] * FQ.r % FQ.modulus, pt[1] * FQ.r % FQ.modulus, FQ.r]
    return ff.to_tensor(ff.words_from_ints(rows), device).reshape(len(pts), 3, ff.W)


def to_affine_ints(p: torch.Tensor) -> list:
    """(..., 3, 8) Jacobian -> flat list of affine (x, y) ints or None."""
    x, y, z = (FQ.decode_many(p[..., i, :]) for i in range(3))
    out = []
    q = FQ.modulus
    for xi, yi, zi in zip(x, y, z):
        if zi == 0:
            out.append(None)
            continue
        zinv = pow(zi, -1, q)
        out.append((xi * zinv * zinv % q, yi * zinv * zinv * zinv % q))
    return out


def neg(p: torch.Tensor) -> torch.Tensor:
    return torch.stack([p[..., 0, :], ff.neg(FQ, p[..., 1, :]), p[..., 2, :]], dim=-2)


def _affine_with(p: torch.Tensor, inv, mul) -> torch.Tensor:
    zi = inv(p[..., 2, :])
    zi2 = mul(zi, zi)
    x = mul(p[..., 0, :], zi2)
    y = mul(p[..., 1, :], mul(zi2, zi))
    return torch.stack([x, y], dim=-2)


def to_affine(p: torch.Tensor) -> torch.Tensor:
    """(..., 3, 8) Jacobian -> (..., 2, 8) affine x = X / Z^2, y = Y / Z^3
    (Montgomery Fq); the identity (z = 0) becomes (0, 0), which is not on
    the curve and is the identity-base sentinel of the MSM kernels (C, G).
    One inversion of every z (inv(0) = 0) and four products: kernel A on
    CUDA tensors, the plain field ops on CPU tensors."""
    return _affine_with(p, lambda z: ff.inv(FQ, z), lambda a, b: ff.mont_mul(FQ, a, b))


# ---------------------------------------------------------------------------
# Plain versions (plain field arithmetic, branchless selects)
# ---------------------------------------------------------------------------

def _plain_double(p: torch.Tensor) -> torch.Tensor:
    x, y, z = p.unbind(-2)
    a = _mul(FQ, x, x)
    b = _mul(FQ, y, y)
    c = _mul(FQ, b, b)
    xb = _add(FQ, x, b)
    d = _sub(FQ, _sub(FQ, _mul(FQ, xb, xb), a), c)
    d = _add(FQ, d, d)
    e = _add(FQ, _add(FQ, a, a), a)
    f = _mul(FQ, e, e)
    x3 = _sub(FQ, f, _add(FQ, d, d))
    c2 = _add(FQ, c, c)
    c4 = _add(FQ, c2, c2)
    c8 = _add(FQ, c4, c4)
    y3 = _sub(FQ, _mul(FQ, e, _sub(FQ, d, x3)), c8)
    yz = _mul(FQ, y, z)
    z3 = _add(FQ, yz, yz)
    return torch.stack([x3, y3, z3], dim=-2)


def _plain_add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    p, q = torch.broadcast_tensors(p, q)
    x1, y1, z1 = p.unbind(-2)
    x2, y2, z2 = q.unbind(-2)
    z1z1 = _mul(FQ, z1, z1)
    z2z2 = _mul(FQ, z2, z2)
    u1 = _mul(FQ, x1, z2z2)
    u2 = _mul(FQ, x2, z1z1)
    s1 = _mul(FQ, _mul(FQ, y1, z2), z2z2)
    s2 = _mul(FQ, _mul(FQ, y2, z1), z1z1)
    h = _sub(FQ, u2, u1)
    r = _sub(FQ, s2, s1)
    r = _add(FQ, r, r)
    h2 = _add(FQ, h, h)
    i = _mul(FQ, h2, h2)
    j = _mul(FQ, h, i)
    v = _mul(FQ, u1, i)
    x3 = _sub(FQ, _sub(FQ, _mul(FQ, r, r), j), _add(FQ, v, v))
    s1j = _mul(FQ, s1, j)
    y3 = _sub(FQ, _mul(FQ, r, _sub(FQ, v, x3)), _add(FQ, s1j, s1j))
    zs = _add(FQ, z1, z2)
    z3 = _mul(FQ, _sub(FQ, _sub(FQ, _mul(FQ, zs, zs), z1z1), z2z2), h)
    out = torch.stack([x3, y3, z3], dim=-2)

    p_inf = ff.is_zero(z1)[..., None, None]
    q_inf = ff.is_zero(z2)[..., None, None]
    h_zero = ff.is_zero(h)[..., None, None]
    r_zero = ff.is_zero(r)[..., None, None]
    same = h_zero & r_zero & ~p_inf & ~q_inf
    opposite = h_zero & ~r_zero & ~p_inf & ~q_inf
    if bool(same.any()):  # the doubling case is rare: compute it only when present
        out = torch.where(same, _plain_double(p), out)
    out = torch.where(opposite, identity(p.shape[:-2], p.device), out)
    out = torch.where(p_inf, q, out)
    return torch.where(q_inf & ~p_inf, p, out)


def _plain_madd(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete mixed addition of (..., 3, 8) Jacobian p and (..., 2, 8)
    affine q: madd-2007-bl, as curve.cuh's pt_madd, with its cases: q = (0, 0)
    (the identity base) gives p, an identity p gives (x2, y2, 1), equal
    points the doubling, opposite points the identity. Its words equal
    ``_plain_add``'s for q lifted to z = 1."""
    batch = torch.broadcast_shapes(p.shape[:-2], q.shape[:-2])
    p = p.expand(*batch, 3, ff.W)
    q = q.expand(*batch, 2, ff.W)
    x1, y1, z1 = p.unbind(-2)
    x2, y2 = q.unbind(-2)
    z1z1 = _mul(FQ, z1, z1)
    u2 = _mul(FQ, x2, z1z1)
    s2 = _mul(FQ, y2, _mul(FQ, z1, z1z1))
    h = _sub(FQ, u2, x1)
    r = _sub(FQ, s2, y1)
    r = _add(FQ, r, r)
    hh = _mul(FQ, h, h)
    i = _add(FQ, hh, hh)
    i = _add(FQ, i, i)
    j = _mul(FQ, h, i)
    v = _mul(FQ, x1, i)
    x3 = _sub(FQ, _sub(FQ, _mul(FQ, r, r), j), _add(FQ, v, v))
    y1j = _mul(FQ, y1, j)
    y3 = _sub(FQ, _mul(FQ, r, _sub(FQ, v, x3)), _add(FQ, y1j, y1j))
    zh = _add(FQ, z1, h)
    z3 = _sub(FQ, _sub(FQ, _mul(FQ, zh, zh), z1z1), hh)
    out = torch.stack([x3, y3, z3], dim=-2)

    base_inf = (ff.is_zero(x2) & ff.is_zero(y2))[..., None, None]
    p_inf = ff.is_zero(z1)[..., None, None] & ~base_inf
    plain = ~base_inf & ~p_inf
    h_zero = ff.is_zero(h)[..., None, None]
    r_zero = ff.is_zero(r)[..., None, None]
    same = h_zero & r_zero & plain
    if bool(same.any()):
        out = torch.where(same, _plain_double(p), out)
    out = torch.where(h_zero & ~r_zero & plain, identity(batch, p.device), out)
    lifted = torch.stack([x2, y2, FQ.mont_one(p.device).expand_as(x2)], dim=-2)
    out = torch.where(p_inf, lifted, out)
    return torch.where(base_inf, p, out)


def scalar_bits(scalars: torch.Tensor) -> torch.Tensor:
    """(..., 8) standard-form words -> (..., 256) bits, LSB first."""
    w = scalars.to(torch.int64) & ff.MASK32
    shifts = torch.arange(32, device=scalars.device)
    return ((w[..., :, None] >> shifts) & 1).reshape(*scalars.shape[:-1], 256)


def _plain_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum a (M, ..., 3, 8) batch along dim 0 by a halving tree."""
    m = 1
    while m < p.shape[0]:
        m *= 2
    if m != p.shape[0]:
        p = torch.cat([p, identity((m - p.shape[0],) + tuple(p.shape[1:-2]), p.device)])
    while m > 1:
        m //= 2
        p = _plain_add(p[:m], p[m:])
    return p[0]


def doubling_table(p: torch.Tensor) -> torch.Tensor:
    """(..., 3, 8) -> (256, ..., 3, 8) of 2^j * p (plain)."""
    rows = [p]
    for _ in range(255):
        rows.append(_plain_double(rows[-1]))
    return torch.stack(rows)


def _plain_scalar_mul_table(table: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """sum_j bit_j(k_i) * 2^j P_i from a doubling table (256, N, 3, 8) and
    (N, 8) standard-form scalars -> (N, 3, 8)."""
    bits = scalar_bits(scalars).T.bool()  # (256, N)
    ident = identity(table.shape[1:-2], table.device)
    picked = torch.where(bits[..., None, None], table, ident)
    return _plain_sum(picked)


@lru_cache(maxsize=8)
def _single_base_table(words: tuple, device: str) -> torch.Tensor:
    """Doubling table of one base point (the SRS generator), cached."""
    p = torch.tensor(words, dtype=torch.int32, device=device).reshape(3, ff.W)
    return doubling_table(p)


def _plain_scalar_mul(p: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    lanes = tuple(scalars.shape[:-1])
    if p.dim() == 2:  # one base for every lane: one table, broadcast
        table = _single_base_table(tuple(p.reshape(-1).tolist()), str(p.device))
        table = table.reshape(256, *([1] * len(lanes)), 3, ff.W)
        return _plain_scalar_mul_table(table.expand(256, *lanes, 3, ff.W), scalars)
    return _plain_scalar_mul_table(doubling_table(p), scalars)


# ---------------------------------------------------------------------------
# Public operations
# ---------------------------------------------------------------------------

def _check_points(name: str, p: torch.Tensor) -> None:
    kernels.check_cuda_tensor(name, p, torch.int32, ff.W)
    if p.dim() < 2 or p.shape[-2] != 3:
        raise ValueError(f"{name}: expected (..., 3, 8) points, got {tuple(p.shape)}")


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete elementwise point addition."""
    if p.device.type == "cpu" and q.device.type == "cpu":
        return _plain_add(p, q)
    if p.shape != q.shape:
        raise ValueError(f"g1 add: shapes differ {tuple(p.shape)} vs {tuple(q.shape)}")
    p, q = p.contiguous(), q.contiguous()
    _check_points("p", p)
    _check_points("q", q)
    out = torch.empty_like(p)
    n = p.numel() // (3 * ff.W)
    kernels.launch("g1_add", "curve", "zk_g1_add", out.data_ptr(), p.data_ptr(), q.data_ptr(), n)
    return out


def double(p: torch.Tensor) -> torch.Tensor:
    if p.device.type == "cpu":
        return _plain_double(p)
    return add(p, p)


def scalar_mul(p: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Per-lane k_i * P_i. p: (3, 8) (one base for every lane) or (N, 3, 8);
    scalars: (N, 8) standard-form words."""
    if p.device.type == "cpu" and scalars.device.type == "cpu":
        return _plain_scalar_mul(p, scalars)
    p, scalars = p.contiguous(), scalars.contiguous()
    _check_points("bases", p)
    kernels.check_cuda_tensor("scalars", scalars, torch.int32, ff.W)
    n = scalars.numel() // ff.W
    if p.dim() == 2:
        stride = 0
    elif p.shape[:-2] == scalars.shape[:-1]:
        stride = 1
    else:
        raise ValueError("scalar_mul: bases must be one point or one per scalar")
    out = torch.empty(*scalars.shape[:-1], 3, ff.W, dtype=torch.int32, device=p.device)
    kernels.launch("g1_scalar_mul", "curve", "zk_g1_scalar_mul", out.data_ptr(), p.data_ptr(),
                   stride, scalars.data_ptr(), n)
    return out


def _plain_to_affine(p: torch.Tensor) -> torch.Tensor:
    return _affine_with(p, lambda z: ff.PLAIN["pow"](FQ, z, FQ.modulus - 2), lambda a, b: _mul(FQ, a, b))


PLAIN = {"add": _plain_add, "double": _plain_double, "scalar_mul": _plain_scalar_mul,
         "sum": _plain_sum, "madd": _plain_madd, "to_affine": _plain_to_affine}
