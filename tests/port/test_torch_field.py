"""The port's field arithmetic (kernel A's plain path on the CPU) against
the JAX reference ``zkevm_tpu/ff/limbs.py``: the same numpy-seeded inputs
through both, compared for exact equality (field elements are integers,
so the tolerance is zero)."""

import jax
import numpy as np
import pytest
import torch

from zkevm_tpu.ff import FQ as JFQ, FR as JFR, limbs
from zkevm_tpu.plonk import prover as jprover
from zkevm_tpu_torch import convert
from zkevm_tpu_torch.ff import field as ff

SPECS = {"Fr": (JFR, ff.FR), "Fq": (JFQ, ff.FQ)}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _elems(rng, p, n):
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    vals[:3] = [0, 1, p - 1]
    return vals


def _pair(rng, name, n=32):
    jspec, spec = SPECS[name]
    a = _elems(rng, spec.modulus, n)
    b = _elems(rng, spec.modulus, n)[::-1]
    ja = np.stack([jspec.encode(v) for v in a])
    jb = np.stack([jspec.encode(v) for v in b])
    return jspec, spec, ja, jb


def _port(x):
    return convert.limbs16_to_words(x, "cpu")


def _same(port_out, jax_out):
    np.testing.assert_array_equal(convert.words_to_limbs16(port_out), np.asarray(jax_out))


@pytest.mark.parametrize("name", ["Fr", "Fq"])
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_reference(rng, name, op):
    jspec, spec, ja, jb = _pair(rng, name)
    jop = {"add": limbs.add, "sub": limbs.sub, "mul": limbs.mont_mul}[op]
    pop = {"add": ff.add, "sub": ff.sub, "mul": ff.mont_mul}[op]
    _same(pop(spec, _port(ja), _port(jb)), jax.jit(lambda x, y: jop(jspec, x, y))(ja, jb))


@pytest.mark.parametrize("name", ["Fr", "Fq"])
@pytest.mark.parametrize("op", ["neg", "sqr", "to_mont", "from_mont"])
def test_unary_ops_match_reference(rng, name, op):
    jspec, spec, ja, _ = _pair(rng, name)
    jop = getattr(limbs, op)
    pop = getattr(ff, op)
    _same(pop(spec, _port(ja)), jax.jit(lambda x: jop(jspec, x))(ja))


@pytest.mark.parametrize("name", ["Fr", "Fq"])
def test_inv_and_pow_match_reference(rng, name):
    jspec, spec, ja, _ = _pair(rng, name, n=8)
    _same(ff.inv(spec, _port(ja)), jax.jit(lambda x: limbs.inv(jspec, x))(ja))
    _same(ff.pow_const(spec, _port(ja), 7), jax.jit(lambda x: limbs.pow_const(jspec, x, 7))(ja))
    assert int(ff.inv(spec, torch.zeros(1, 8, dtype=torch.int32)).abs().sum()) == 0  # inv(0) = 0



# Python-int model of each op on the raw words (Montgomery form, R = 2^256):
# an independent reference for the same edge values and random pairs.
_PY_OPS = {
    "add": lambda p, x, y: (x + y) % p,
    "sub": lambda p, x, y: (x - y) % p,
    "mont_mul": lambda p, x, y: x * y * pow(1 << 256, -1, p) % p,
    "sqr": lambda p, x, y: x * x * pow(1 << 256, -1, p) % p,
    "neg": lambda p, x, y: -x % p,
    "to_mont": lambda p, x, y: x * (1 << 256) % p,
    "from_mont": lambda p, x, y: x * pow(1 << 256, -1, p) % p,
    "pow_const": lambda p, x, y: pow(x * pow(1 << 256, -1, p), 13, p) * (1 << 256) % p,
    "inv": lambda p, x, y: 0 if x == 0 else pow(x * pow(1 << 256, -1, p), -1, p) * (1 << 256) % p,
}


@pytest.mark.parametrize("name", ["Fr", "Fq"])
@pytest.mark.parametrize("op", list(_PY_OPS))
def test_ops_match_python_ints(rng, name, op):
    """Every pair of the edge values 0, 1, 2, p-2, p-1, then random pairs."""
    spec = SPECS[name][1]
    p = spec.modulus
    edges = [0, 1, 2, p - 2, p - 1]
    a = [x for x in edges for _ in edges] + _elems(rng, p, 8)
    b = edges * len(edges) + _elems(rng, p, 8)[::-1]
    ta, tb = (ff.to_tensor(ff.words_from_ints(v), "cpu") for v in (a, b))
    if op in ("add", "sub", "mont_mul"):
        got = getattr(ff, op)(spec, ta, tb)
    elif op == "pow_const":
        got = ff.pow_const(spec, ta, 13)
    else:
        got = getattr(ff, op)(spec, ta)
    assert ff.ints_from_words(got) == [_PY_OPS[op](p, x, y) for x, y in zip(a, b)]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_sum_rows_and_prefix_product_match_python_ints(rng, n):
    vals = _elems(rng, ff.FR.modulus, n)
    p = ff.FR.modulus
    enc = ff.to_tensor(ff.FR.encode_many(vals), "cpu")
    assert ff.FR.decode(ff.sum_rows(ff.FR, enc, 0)[None]) == sum(vals) % p
    want, acc = [], 1
    for v in vals:
        want.append(acc)
        acc = acc * v % p
    assert ff.FR.decode_many(ff.prefix_product(ff.FR, enc)) == want

def test_broadcasting(rng):
    _, spec, ja, jb = _pair(rng, "Fr", n=6)
    a = _port(ja).reshape(2, 3, 8)
    got = ff.mont_mul(spec, a[:, :, None, :], _port(jb)[:2])  # (2, 3, 1, 8) x (2, 8)
    want = limbs.mont_mul(JFR, ja.reshape(2, 3, 1, 16), jb[:2])
    assert got.shape == (2, 3, 2, 8)
    _same(got, want)


def test_repack_round_trip(rng):
    raw = rng.integers(0, 1 << 16, size=(5, 3, 16), dtype=np.uint32)
    words = convert.limbs16_to_words(raw, device="cpu")
    assert words.dtype == torch.int32 and words.shape == (5, 3, 8)
    np.testing.assert_array_equal(convert.words_to_limbs16(words), raw)
    ints = ff.ints_from_words(words)
    assert ints == limbs.ints_from_limbs(raw.reshape(-1, 16))


def test_prefix_product_matches_reference(rng):
    _, spec, ja, _ = _pair(rng, "Fr", n=16)
    _same(ff.prefix_product(spec, _port(ja)), jprover.prefix_product(ja))


def test_host_encode_decode(rng):
    for jspec, spec in SPECS.values():
        vals = _elems(rng, spec.modulus, 10)
        enc = spec.encode_many(vals)
        np.testing.assert_array_equal(convert.words_to_limbs16(enc), np.stack([jspec.encode(v) for v in vals]))
        assert spec.decode_many(enc) == vals


def test_device_selection_and_kernel_checks(monkeypatch):
    """Entry points default to CUDA and raise without it; kernel wrappers
    take only CUDA tensors of the expected dtype and layout."""
    from zkevm_tpu_torch import kernels
    from zkevm_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    x = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        ff._launch_binary(ff.FR, "mul", x, x)
    with pytest.raises(ValueError):
        kernels.check_cuda_tensor("x", x, torch.int32, 8)
    with pytest.raises(ValueError):
        ff.add(ff.FR, x, x.to(torch.float64))  # no mixing of unsupported devices/dtypes
