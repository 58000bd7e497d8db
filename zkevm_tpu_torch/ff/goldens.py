"""Pure-Python (arbitrary-precision int) reference field arithmetic.

This is the golden model the port's field kernels are tested against, playing the
role halo2curves' test vectors play for the reference
(reference: halo2curves 0.1, imported at Cargo.toml:41).
Everything here is host-side, slow, and obviously correct.
"""

from __future__ import annotations

# BN254 base field (Fq) and scalar field (Fr) moduli.
FQ_MOD = 21888242871839275222246405745257275088696311157297823662689037894645226208583
FR_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# Multiplicative generator of Fr (halo2curves bn256::Fr GENERATOR = 7) and
# 2-adicity S = 28: r - 1 = 2^28 * t with t odd.
FR_GENERATOR = 7
FR_TWO_ADICITY = 28

# Fq has 2-adicity 1 (q - 1 = 2 * odd); only Fr hosts NTT domains.


def inv_mod(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def fr_root_of_unity(k: int) -> int:
    """Primitive 2^k-th root of unity in Fr."""
    assert 0 <= k <= FR_TWO_ADICITY
    t = (FR_MOD - 1) >> FR_TWO_ADICITY
    root = pow(FR_GENERATOR, t, FR_MOD)  # order 2^28
    for _ in range(FR_TWO_ADICITY - k):
        root = root * root % FR_MOD
    return root


def sqrt_mod(a: int, m: int) -> int | None:
    """Tonelli-Shanks square root; returns None if a is a non-residue."""
    if a == 0:
        return 0
    if pow(a, (m - 1) // 2, m) != 1:
        return None
    # write m - 1 = q * 2^s
    q, s = m - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    if s == 1:
        return pow(a, (m + 1) // 4, m)
    # find a non-residue
    z = 2
    while pow(z, (m - 1) // 2, m) != m - 1:
        z += 1
    c = pow(z, q, m)
    x = pow(a, (q + 1) // 2, m)
    t = pow(a, q, m)
    mm = s
    while t != 1:
        i, tt = 0, t
        while tt != 1:
            tt = tt * tt % m
            i += 1
        b = pow(c, 1 << (mm - i - 1), m)
        x = x * b % m
        t = t * b * b % m
        c = b * b % m
        mm = i
    return x
