"""Pure-Python golden model for BN254 G1/G2 group arithmetic.

Plays the role of halo2curves' bn256 curve tests in the reference stack
(reference: halo2curves 0.1 at Cargo.toml:41). Everything is
arbitrary-precision int, affine coordinates, obviously correct, host-only.
"""

from __future__ import annotations

from zkevm_tpu_torch.ff.goldens import FQ_MOD, FR_MOD, sqrt_mod

P = FQ_MOD
R = FR_MOD

# y^2 = x^3 + 3 over Fq; generator (1, 2). Identity is represented as None.
B_COEFF = 3
G1_GEN = (1, 2)


def is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - B_COEFF) % P == 0


def neg(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, (-y) % P)


def add(p1, p2):
    """Affine addition (complete, slow)."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, P) % P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def double(pt):
    return add(pt, pt)


def scalar_mul(pt, k: int):
    k %= R
    out = None
    acc = pt
    while k:
        if k & 1:
            out = add(out, acc)
        acc = add(acc, acc)
        k >>= 1
    return out


def msm(points, scalars):
    out = None
    for pt, s in zip(points, scalars):
        out = add(out, scalar_mul(pt, s))
    return out


def random_point(rng):
    """Sample a uniformly random G1 point by hashing x-candidates."""
    while True:
        x = int(rng.integers(0, 1 << 62))
        for _ in range(3):
            x = (x << 62) | int(rng.integers(0, 1 << 62))
        x %= P
        y2 = (x * x * x + B_COEFF) % P
        y = sqrt_mod(y2, P)
        if y is not None:
            if int(rng.integers(0, 2)):
                y = P - y
            return (x, y)
