"""Kernel J's plain path (``zkevm_tpu_torch/ff/lazy13.py``) on the CPU against
the JAX reference ``zkevm_tpu/ff/lazy13.py``, run live and eagerly on the same
numpy-seeded lazy inputs (13-bit limbs of v + m p, not reduced): every
constant, every op and the conversions word for word (the values are
integers, so the tolerance is zero); then a 200-deep random op chain and the
edge values against Python integers, as ``tests/test_lazy13.py`` holds the
reference."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zkevm_tpu.ff import lazy13 as rl
from zkevm_tpu.ff.limbs import fq_spec, fr_spec
from zkevm_tpu_torch import convert
from zkevm_tpu_torch.ff import lazy13 as lz

FIELDS = {"Fq": (fq_spec, lz.ctx_fq), "Fr": (fr_spec, lz.ctx_fr)}
# the scale tuples of the point formulas (ec/msm13.py)
SCALES = [(1,), (2,), (3,), (4,), (2, -2), (1, -8), (1, -1, -1), (2, -2, -2), (4, -4, -8)]
N = 64


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module", params=list(FIELDS))
def ctx(request):
    ref_spec, port_ctx = FIELDS[request.param]
    return rl._ctx(ref_spec()), port_ctx()


def _lazy(rng, p, n=N):
    """(21, n) uint32 strict limbs of v + m p (v < p, m < 400: value < 2^263)."""
    vals = [int.from_bytes(rng.bytes(32), "little") % p + int(rng.integers(0, 400)) * p for _ in range(n)]
    return np.array([[(v >> (13 * i)) & 0x1FFF for v in vals] for i in range(21)], dtype=np.uint32)


def _port(a):
    return convert.l13_from_reference(a, "cpu")


def _same(port_out, ref_out):
    np.testing.assert_array_equal(convert.l13_to_reference(port_out), np.asarray(ref_out, dtype=np.uint32))


def test_constants_equal_reference(ctx):
    ref, port = ctx
    np.testing.assert_array_equal(port.C, ref.C)
    for name in ("w262", "kp_t", "kp_limbs", "p_limbs13"):
        np.testing.assert_array_equal(getattr(port, name), np.asarray(getattr(ref, name)).astype(np.int64), name)
    assert (port.m_kp, port.mu, port.mu_k) == (ref.m_kp, ref.mu, ref.mu_k)
    for scales in SCALES:
        np.testing.assert_array_equal(lz._scaled_C(port, scales), rl._scaled_C(ref, scales))


@pytest.mark.parametrize("op", ["mul13", "sqr13", "add13", "sub13", "canon13", "is_zero13"])
def test_ops_match_reference(ctx, op):
    ref, port = ctx
    rng = np.random.default_rng(11)
    a, b = _lazy(rng, ref.p), _lazy(rng, ref.p)
    if op == "is_zero13":  # zeros among the lanes: x - x
        d = np.asarray(rl.sub13(ref, jnp.asarray(a), jnp.asarray(a)))
        a = np.where(np.arange(N) % 3 == 0, d, a).astype(np.uint32)
    unary = op in ("sqr13", "canon13", "is_zero13")
    ref_args = (jnp.asarray(a),) if unary else (jnp.asarray(a), jnp.asarray(b))
    port_args = (_port(a),) if unary else (_port(a), _port(b))
    got = getattr(lz, op)(port, *port_args)
    want = getattr(rl, op)(ref, *ref_args)
    if op == "is_zero13":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.any() and not got.all()
    else:
        _same(got, want)


@pytest.mark.parametrize("scales", SCALES, ids=lambda s: ",".join(map(str, s)))
def test_combine_reduce_matches_reference(ctx, scales):
    ref, port = ctx
    rng = np.random.default_rng(12)
    xs = [_lazy(rng, ref.p) for _ in range(len(scales) + 1)]
    ref_terms = [(rl.prod_T(jnp.asarray(xs[k]), jnp.asarray(xs[k + 1])), s) for k, s in enumerate(scales)]
    port_terms = [(lz.prod_T(_port(xs[k]), _port(xs[k + 1])), s) for k, s in enumerate(scales)]
    for (t, _), (jt, _) in zip(port_terms, ref_terms):
        _same(t, jt)
    _same(lz.combine_reduce(port, port_terms), rl.combine_reduce(ref, ref_terms))
    _same(lz.sqr_T(_port(xs[0])), rl.sqr_T(jnp.asarray(xs[0])))


def test_conversions_match_reference(ctx):
    from zkevm_tpu.ff import limbs

    ref, port = ctx
    rng = np.random.default_rng(13)
    vals = [int.from_bytes(rng.bytes(32), "little") % ref.p for _ in range(N)]
    vals[:3] = [0, 1, ref.p - 1]
    a16 = limbs.limbs_from_ints(vals)  # (N, 16) standard form
    words = convert.limbs16_to_words(a16, "cpu")
    a13 = lz.from_words(words)
    _same(a13, rl.from_u16_t(jnp.asarray(a16.T)))
    lazy_a = _lazy(rng, ref.p)
    canon = lz.canon13(port, _port(lazy_a))
    _same(canon, rl.canon13(ref, jnp.asarray(lazy_a)))
    np.testing.assert_array_equal(convert.words_to_limbs16(lz.to_words(canon)).T,
                                  np.asarray(rl.to_u16_t(rl.canon13(ref, jnp.asarray(lazy_a)))))
    assert port.to_ints(a13) == vals
    np.testing.assert_array_equal(convert.l13_to_reference(_port(lazy_a)), lazy_a)


def test_long_random_chain_and_edges(ctx):
    """Outputs fed back as inputs 200 deep against Python integers (a lazy
    bound slip would corrupt a value), then the edge values."""
    _, port = ctx
    p = port.p
    rng = np.random.default_rng(14)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(16)]
    regs = port.tensor(vals, "cpu")
    for _ in range(200):
        op = int(rng.integers(0, 4))
        i, j, k = (int(v) for v in rng.integers(0, 16, size=3))
        a, b = regs[:, i : i + 1], regs[:, j : j + 1]
        r, vals[k] = [(lz.mul13(port, a, b), vals[i] * vals[j]), (lz.add13(port, a, b), vals[i] + vals[j]),
                      (lz.sub13(port, a, b), vals[i] - vals[j]), (lz.sqr13(port, a), vals[i] * vals[i])][op]
        vals[k] %= p
        regs[:, k : k + 1] = r
        assert int(r.max()) < (1 << 13) + (1 << 6) and int(r[20, 0]) <= 8
    assert port.to_ints(regs) == vals
    assert port.to_ints(lz.canon13(port, regs)) == vals
    edges = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, 1 << 13, (1 << 247) % p]
    a, b = port.tensor(edges, "cpu"), port.tensor(edges[::-1], "cpu")
    assert port.to_ints(lz.mul13(port, a, b)) == [x * y % p for x, y in zip(edges, edges[::-1])]
    assert port.to_ints(lz.sub13(port, a, b)) == [(x - y) % p for x, y in zip(edges, edges[::-1])]
    assert bool(lz.is_zero13(port, lz.sub13(port, a, a)).all())
    assert lz.is_zero13(port, a).tolist() == [v == 0 for v in edges]
    assert bool(lz.eq13(port, lz.add13(port, a, b), lz.add13(port, b, a)).all())
