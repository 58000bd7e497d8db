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
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
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


def test_fused_coset_and_scale_match_reference_on_a_batch(rng):
    """The transforms with the coset powers and 1/n taken as their first
    load and last store (fft_core's pre and post, as kernel B takes them):
    coset_ntt, coset_intt and intt of a batch of 3 columns at k = 3 against
    the reference's, live, column by column (one compile of the reference,
    ~10 s)."""
    k = 3
    a = np.stack([_enc(_rand(rng, 1 << k)) for _ in range(3)])
    ref = jax.jit(lambda x: (jntt.coset_ntt(x, 7), jntt.coset_intt(x, 7), jntt.intt(x, k)))
    pa = convert.limbs16_to_words(a, device="cpu")
    got = (ntt.coset_ntt(pa, 7), ntt.coset_intt(pa, 7), ntt.intt(pa, k))
    for col in range(3):
        for g, w in zip(got, ref(a[col])):
            _same(g[col], w)
    # pre and post as tables: the powers of 5 on the way in, of 3 on the way out
    pre, post = ntt.power_table(5, 1 << k, "cpu"), ntt.power_table(3, 1 << k, "cpu")
    want = ntt.scale_by_powers(ntt.ntt(ntt.scale_by_powers(pa, 5), k), 3)
    assert torch.equal(ntt.fft_core(pa, k, False, pre=pre, post=post), want)


def test_fft_passes_cover_every_k():
    """Kernel B's pass schedule: one pass up to 2^12 elements, two up to
    2^24, three up to 2^36, each within csrc/ntt.cu's limits (sub-transforms
    of at most 2^12 elements, column passes over at most 2^24 columns);
    larger k is refused."""
    for k in range(1, 37):
        passes = ntt.fft_passes(k)
        assert len(passes) == 1 + (k > 12) + (k > 24), (k, passes)
        assert passes[-1][:2] == ("rows", "out") and passes[0][2] == "in"
        for kind, dst, src, m, sub, outer in passes:
            assert dst != src
            if kind == "cols":
                assert 1 <= sub <= 12 and 1 <= m - sub <= 24 and m <= k and outer == 0, (k, passes)
            else:
                assert 1 <= m <= 12 and 0 <= sub <= 12 and 0 <= outer <= 12, (k, passes)
                assert m + sub + outer == k, (k, passes)
    with pytest.raises(ValueError, match="three passes"):
        ntt.fft_passes(37)


def _model_cols(dst, src, m, k1, count, pre, inverse):
    """csrc/ntt.cu's column pass on the CPU: ``count`` transforms of 2^m
    viewed as 2^k1 rows; each column transformed (times ``pre`` on its
    loads), output row r of column c times w^(r c), w the 2^m-th root."""
    x = src[: count << m].reshape(count, 1 << k1, 1 << (m - k1), 8)
    if pre is not None:
        x = ff.PLAIN["mul"](FR, x, pre.reshape(1 << k1, 1 << (m - k1), 8))
    dst[: count << m] = ntt.PLAIN["ntt4_cols"](x, m, 0, inverse).reshape(-1, 8)


def _model_rows(dst, src, k2, log_n1, log_outer, rows, pre, post, scale, inverse):
    """csrc/ntt.cu's row pass on the CPU, with rows_kernel's store index."""
    x = src[: rows << k2].reshape(rows, 1 << k2, 8)
    if pre is not None:
        x = ff.PLAIN["mul"](FR, x, pre)
    x = ntt.PLAIN["fft"](x, k2, ntt._omega_powers(k2, inverse, "cpu"))
    r, c = torch.arange(rows)[:, None], torch.arange(1 << k2)[None, :]
    b = r >> log_n1
    i = (r & ((1 << log_n1) - 1)) + (c << log_n1)
    o = (b & ((1 << log_outer) - 1)) + (i << log_outer)
    if post is not None:
        x = ff.PLAIN["mul"](FR, x, post[o])
    elif scale is not None:
        x = ff.PLAIN["mul"](FR, x, scale)
    dst[((b >> log_outer) << (k2 + log_n1 + log_outer)) + o] = x


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("mode", ["coset_ntt", "intt", "coset_intt"])
def test_fft_passes_compose_the_transform(rng, k, mode):
    """The launches of fft_passes with sub-transforms of at most 2^2
    elements (so k = 5, 6 take the three passes and k = 3, 4 two), run on
    the CPU through models of csrc/ntt.cu's passes, equal fft_core's plain
    transform, with pre to the first pass and post or 1/n to the last."""
    batch, n = 2, 1 << k
    a = torch.stack([convert.limbs16_to_words(_enc(_rand(rng, n)), device="cpu") for _ in range(batch)])
    inverse = mode != "coset_ntt"
    pre = ntt.power_table(7, n, "cpu") if mode == "coset_ntt" else None
    post = ntt.power_table(3, n, "cpu") if mode == "coset_intt" else None
    scale = ntt._n_inv(k, "cpu") if mode == "intt" else None
    buf = {"in": a.reshape(-1, 8), "out": torch.zeros(batch * n, 8, dtype=torch.int32),
           "scratch": torch.zeros(batch * n, 8, dtype=torch.int32)}
    passes = ntt.fft_passes(k, sub=2)
    for i, (kind, dst, src, m, sub, outer) in enumerate(passes):
        first, last = pre if i == 0 else None, i == len(passes) - 1
        if kind == "cols":
            _model_cols(buf[dst], buf[src], m, sub, batch << (k - m), first, inverse)
        else:
            _model_rows(buf[dst], buf[src], m, sub, outer, batch << (k - m), first, post if last else None,
                        scale if last else None, inverse)
    want = ntt.fft_core(a, k, inverse, pre=pre, post=post, scale=scale)
    assert torch.equal(buf["out"].reshape(batch, n, 8), want)
