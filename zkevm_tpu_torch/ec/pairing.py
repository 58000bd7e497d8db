"""Pure-Python BN254 pairing (host golden; used by the KZG verifier gate).

Replaces the pairing path of halo2curves bn256 in the reference stack
(reference: Cargo.toml:41; pairing checks at
aggregator/src/core.rs:111 `extract_accumulators_and_proof`). This is a
deliberately simple, obviously-correct construction for host-side
verification of KZG openings and SRS consistency — the production proof is
verified on-chain, so host verification only needs bilinearity and
non-degeneracy, not speed:

- Fq2 = Fq[i]/(i^2 + 1), Fq12 = Fq2[w]/(w^6 - xi) with xi = 9 + i
  (a flat tower equivalent to the standard 2-3-2 tower).
- G2 is the D-twist y^2 = x^3 + 3/xi over Fq2; untwist
  psi(x, y) = (x w^2, y w^3) maps into E(Fq12).
- e(P, Q) = Tate pairing: Miller loop f_{r,P} evaluated at psi(Q), then the
  full final exponentiation (p^12 - 1)/r. ~2 s per pairing in CPython.
"""

from __future__ import annotations

from functools import lru_cache

from zkevm_tpu_torch.ff.goldens import FQ_MOD as P, FR_MOD as R

# ---------------------------------------------------------------------------
# Fq2
# ---------------------------------------------------------------------------

def f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def f2_mul(a, b):
    return (
        (a[0] * b[0] - a[1] * b[1]) % P,
        (a[0] * b[1] + a[1] * b[0]) % P,
    )


def f2_sqr(a):
    return f2_mul(a, a)


def f2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def f2_inv(a):
    d = pow(a[0] * a[0] + a[1] * a[1], P - 2, P)
    return (a[0] * d % P, (-a[1]) * d % P)


F2_ZERO = (0, 0)
F2_ONE = (1, 0)
XI = (9, 1)  # the sextic non-residue 9 + i


# ---------------------------------------------------------------------------
# Fq12 = Fq2[w] / (w^6 - XI): elements are 6-tuples of Fq2 coefficients
# ---------------------------------------------------------------------------

F12_ONE = (F2_ONE,) + (F2_ZERO,) * 5
F12_ZERO = (F2_ZERO,) * 6


def f12_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f12_mul(a, b):
    acc = [F2_ZERO] * 11
    for i, ai in enumerate(a):
        if ai == F2_ZERO:
            continue
        for j, bj in enumerate(b):
            if bj == F2_ZERO:
                continue
            acc[i + j] = f2_add(acc[i + j], f2_mul(ai, bj))
    out = list(acc[:6])
    for k in range(6, 11):
        out[k - 6] = f2_add(out[k - 6], f2_mul(acc[k], XI))
    return tuple(out)


def f12_sqr(a):
    return f12_mul(a, a)


def f12_pow(a, e: int):
    out = F12_ONE
    base = a
    while e:
        if e & 1:
            out = f12_mul(out, base)
        base = f12_sqr(base)
        e >>= 1
    return out


def f12_inv(a):
    # Inverse via exponentiation (|Fq12*| = p^12 - 1); slow but golden.
    return f12_pow(a, P**12 - 2)


def f12_from_fq(x: int):
    return ((x % P, 0),) + (F2_ZERO,) * 5


def f12_from_fq2(x):
    return (x,) + (F2_ZERO,) * 5


# w^2 and w^3 as Fq12 elements (coefficient basis 1, w, ..., w^5)
W2 = (F2_ZERO, F2_ZERO, F2_ONE, F2_ZERO, F2_ZERO, F2_ZERO)
W3 = (F2_ZERO, F2_ZERO, F2_ZERO, F2_ONE, F2_ZERO, F2_ZERO)


# ---------------------------------------------------------------------------
# G2: y^2 = x^3 + 3/xi over Fq2 (affine tuples ((x0,x1),(y0,y1)); None = O)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=1)
def b2() -> tuple:
    return f2_mul((3, 0), f2_inv(XI))


G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return f2_sqr(y) == f2_add(f2_mul(f2_sqr(x), x), b2())


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(f2_mul((3, 0), f2_sqr(x1)), f2_inv(f2_add(y1, y1)))
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sqr(lam), x1), x2)
    y3 = f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1)
    return (x3, y3)


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], f2_neg(pt[1]))


def g2_scalar_mul(pt, k: int):
    k %= R
    out, acc = None, pt
    while k:
        if k & 1:
            out = g2_add(out, acc)
        acc = g2_add(acc, acc)
        k >>= 1
    return out


def untwist(pt):
    """E'(Fq2) -> E(Fq12): (x, y) -> (x w^2, y w^3)."""
    x, y = pt
    return (f12_mul(f12_from_fq2(x), W2), f12_mul(f12_from_fq2(y), W3))


# ---------------------------------------------------------------------------
# Tate pairing
# ---------------------------------------------------------------------------

def miller_loop(p1, q12):
    """f_{r, P} evaluated at Q (Q already untwisted into Fq12 coords)."""
    qx, qy = q12
    f = F12_ONE
    tx, ty = p1  # current point T, affine over Fq
    bits = bin(R)[3:]  # MSB is implicit (start at T = P)
    for b in bits:
        # tangent line at T, evaluated at Q
        lam_num = 3 * tx * tx % P
        lam_den = 2 * ty % P
        lam = lam_num * pow(lam_den, P - 2, P) % P
        # l(Q) = qy - ty - lam * (qx - tx)
        l_val = f12_add(
            f12_add(qy, f12_from_fq(-ty % P)),
            f12_mul(f12_from_fq(-lam % P), f12_add(qx, f12_from_fq(-tx % P))),
        )
        f = f12_mul(f12_sqr(f), l_val)
        # T = 2T
        nx = (lam * lam - 2 * tx) % P
        ny = (lam * (tx - nx) - ty) % P
        tx, ty = nx, ny
        if b == "1":
            if tx == p1[0] and (ty + p1[1]) % P == 0:
                # vertical line through T and P = -T
                l_val = f12_add(qx, f12_from_fq(-tx % P))
                f = f12_mul(f, l_val)
                tx, ty = None, None  # T = O; r's bit pattern never hits this mid-loop
            else:
                lam = (p1[1] - ty) * pow((p1[0] - tx) % P, P - 2, P) % P
                l_val = f12_add(
                    f12_add(qy, f12_from_fq(-ty % P)),
                    f12_mul(
                        f12_from_fq(-lam % P), f12_add(qx, f12_from_fq(-tx % P))
                    ),
                )
                f = f12_mul(f, l_val)
                nx = (lam * lam - tx - p1[0]) % P
                ny = (lam * (tx - nx) - ty) % P
                tx, ty = nx, ny
    # after the loop T = r*P - P ... with MSB-implicit start, T ends at r*P = O
    # only if we include the final vertical; for r odd the last addition above
    # already lands on T = -P? No: the standard Miller loop over the full r
    # leaves T = r*P = O with the last line vertical — absorbed in final exp
    # since vertical-at-O contributes a factor fixed by exponentiation. The
    # classic simplification (BKLS): for even embedding degree the final
    # vertical line can be omitted.
    return f


@lru_cache(maxsize=1)
def _final_exp() -> int:
    return (P**12 - 1) // R


def pairing(p1, q2) -> tuple:
    """e(P, Q): P affine G1 (int pair), Q affine G2 (Fq2 pair). -> Fq12."""
    if p1 is None or q2 is None:
        return F12_ONE
    f = miller_loop(p1, untwist(q2))
    return f12_pow(f, _final_exp())


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1: the form every KZG / accumulator check takes."""
    acc = F12_ONE
    for p1, q2 in pairs:
        acc = f12_mul(acc, pairing(p1, q2))
    return acc == F12_ONE
