"""The port's four-step NTT (kernel I's plain path on the CPU): ``ntt_t`` and
``intt_t`` against the reference's recorded outputs at k = 8 and 9
(``tests/vectors/torch_port_mesh.json``), against the reference's
``zkevm_tpu/poly/ntt.py`` ``ntt_t`` live at k <= 6, against the port's
radix-2 ``ntt`` / ``intt`` for k = 1..12, and the round trip. All exact."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zkevm_tpu.ff import FR as JFR
from zkevm_tpu.poly import ntt as jntt
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.poly import ntt

VECTORS = Path(__file__).resolve().parent.parent / "vectors" / "torch_port_mesh.json"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vectors():
    return json.loads(VECTORS.read_text())


def _rand(rng, n):
    return [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(n)]


def _words(vals):
    return ff.to_tensor(FR.encode_many(vals), "cpu")


@pytest.mark.parametrize("direction", ["ntt", "intt"])
@pytest.mark.parametrize("k", ["8", "9"])
def test_ntt_t_matches_recorded_reference(vectors, k, direction):
    a = _words(vectors["ntt_t"][k])
    got = ntt.ntt_t(a, int(k)) if direction == "ntt" else ntt.intt_t(a, int(k))
    assert FR.decode_many(got) == vectors["ntt_t_out"][k][direction]


@pytest.mark.parametrize("k", [3, 6])
def test_ntt_t_matches_reference_live(rng, k):
    vals = _rand(rng, 1 << k)
    a_t = jnp.asarray(np.stack([JFR.encode(v) for v in vals]).T)  # the reference's (16, n)
    a = _words(vals)
    assert FR.decode_many(ntt.ntt_t(a, k)) == [JFR.decode(v) for v in np.asarray(jntt.ntt_t(a_t, k)).T]
    assert FR.decode_many(ntt.intt_t(a, k)) == [JFR.decode(v) for v in np.asarray(jntt.intt_t(a_t, k)).T]


@pytest.mark.parametrize("k", range(1, 13))
def test_ntt_t_matches_radix2(rng, k):
    """Both branches (one transform at k <= 7, four steps above; odd k has
    k1 != k2) equal kernel B's transform, in a batch of two."""
    a = torch.stack([_words(_rand(rng, 1 << k)) for _ in range(2)])
    assert torch.equal(ntt.ntt_t(a, k), ntt.ntt(a, k))
    assert torch.equal(ntt.intt_t(a, k), ntt.intt(a, k))


@pytest.mark.parametrize("k", [7, 8, 11])
def test_round_trip(rng, k):
    a = _words(_rand(rng, 1 << k))
    assert torch.equal(ntt.intt_t(ntt.ntt_t(a, k), k), a)


def test_passes_reject_bad_shapes():
    a = torch.zeros(1, 8, 8, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        ntt.ntt4_cols(a, 6, c0=1)  # columns 1..8 of an 8-column matrix
    with pytest.raises(ValueError):
        ntt.ntt4_rows(a, 6, 3, parts=3)
    with pytest.raises(ValueError):
        ntt.ntt_t(a, 25)  # a sub-transform above 2^12
    with pytest.raises(ValueError):
        ntt.ntt_t(a, 5)  # 8 rows, not 32
