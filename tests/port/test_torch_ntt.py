"""The port's NTT and domain ops (kernel B's plain path on the CPU) against
the JAX reference ``zkevm_tpu/poly``, exact equality at k <= 6."""

import jax
import numpy as np
import pytest
import torch

from zkevm_tpu.ff import FR as JFR
from zkevm_tpu.ff.goldens import FR_MOD
from zkevm_tpu.poly import Domain as JDomain, goldens as pg, ntt as jntt
from zkevm_tpu_torch import convert
from zkevm_tpu_torch.poly import Domain, ntt


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rand(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(n)]


def _enc(vals):
    return np.stack([JFR.encode(v) for v in vals])


def _same(port_out, jax_out):
    np.testing.assert_array_equal(convert.words_to_limbs16(port_out), np.asarray(jax_out))


@pytest.mark.parametrize("k", [1, 3, 6])
def test_ntt_and_intt_match_reference(rng, k):
    a = _enc(_rand(rng, 1 << k))
    want_ntt, want_intt = jax.jit(lambda x: (jntt.ntt(x, k), jntt.intt(x, k)))(a)
    got = ntt.ntt(convert.limbs16_to_words(a, device="cpu"), k)
    _same(got, want_ntt)
    assert JFR.decode_many(convert.words_to_limbs16(got)) == pg.naive_ntt(
        JFR.decode_many(a), pg.domain_omega(k))
    _same(ntt.intt(convert.limbs16_to_words(a, device="cpu"), k), want_intt)



def _naive(op, vals, k, shift=7):
    """The reference's host golden DFT (``zkevm_tpu/poly/goldens.py``), with
    the coset shift applied to the coefficients."""
    w = pg.domain_omega(k)
    if op == "ntt":
        return pg.naive_ntt(vals, w)
    if op == "intt":
        return pg.naive_intt(vals, w)
    if op == "coset_ntt":
        return pg.naive_ntt([v * pow(shift, i, FR_MOD) % FR_MOD for i, v in enumerate(vals)], w)
    sinv = pow(shift, -1, FR_MOD)
    return [c * pow(sinv, i, FR_MOD) % FR_MOD for i, c in enumerate(pg.naive_intt(vals, w))]


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("op", ["ntt", "intt", "coset_ntt", "coset_intt"])
def test_transforms_match_naive_dft(rng, op, k):
    vals = _rand(rng, 1 << k)
    vals[:2] = [0, FR_MOD - 1]
    a = convert.limbs16_to_words(_enc(vals), device="cpu")
    got = getattr(ntt, op)(a, 7) if op.startswith("coset") else getattr(ntt, op)(a, k)
    assert JFR.decode_many(convert.words_to_limbs16(got)) == _naive(op, vals, k)

def test_batched_and_coset_match_reference(rng):
    k = 4
    a = np.stack([_enc(_rand(rng, 1 << k)) for _ in range(3)])
    want = jax.jit(lambda x: (jntt.ntt(x, k), jntt.coset_ntt(x[0], 7), jntt.coset_intt(x[0], 7),
                              jntt.scale_by_powers(x[0], 5)))(a)
    pa = convert.limbs16_to_words(a, device="cpu")
    got = (ntt.ntt(pa, k), ntt.coset_ntt(pa[0], 7), ntt.coset_intt(pa[0], 7),
           ntt.scale_by_powers(pa[0], 5))
    for g, w in zip(got, want):
        _same(g, w)


def test_domain_ops_match_reference(rng):
    jdom, dom = JDomain.new(3, 4), Domain.new(3, 4)
    assert (dom.k, dom.extended_k) == (jdom.k, jdom.extended_k)
    coeffs = _enc(_rand(rng, dom.n))

    def reference(c):
        ext = jdom.coeff_to_extended(c)
        return ext, jdom.divide_by_vanishing_poly(ext), jdom.extended_to_coeff(ext)

    jext, jdiv, jback = jax.jit(reference)(coeffs)
    ext = dom.coeff_to_extended(convert.limbs16_to_words(coeffs, device="cpu"))
    _same(ext, jext)
    _same(dom.divide_by_vanishing_poly(ext), jdiv)
    _same(dom.extended_to_coeff(ext), jback)


def test_vanishing_division_recovers_quotient(rng):
    dom = Domain.new(3, 4)
    h = _rand(rng, dom.n)
    e = [(-v) % FR_MOD for v in h] + h  # h(X) * (X^n - 1)
    pad = np.zeros((dom.extended_n - 2 * dom.n, 16), np.uint32)
    e_ext = ntt.coset_ntt(convert.limbs16_to_words(np.concatenate([_enc(e), pad]), device="cpu"), dom.g_coset)
    got = JFR.decode_many(convert.words_to_limbs16(dom.extended_to_coeff(dom.divide_by_vanishing_poly(e_ext))))
    assert got[: dom.n] == h and not any(got[dom.n:])
