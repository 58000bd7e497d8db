"""The port's Poseidon (plain path of kernel E on the CPU) and its
PoseidonTranscript against the JAX reference: the constants, the plain
permutation, its trace and the sponge against the reference's golden
model and against the reference's JAX ``permute`` / ``hash_many`` outputs
recorded in ``tests/vectors/torch_port_mpt.json``; the transcript's
challenges on one absorb sequence. Every comparison is exact."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zkevm_tpu.hash import poseidon as jpos
from zkevm_tpu.transcript import PoseidonTranscript as JPoseidonTranscript
from zkevm_tpu_torch.ec import goldens as g1g, group
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FQ_MOD, FR_MOD
from zkevm_tpu_torch.hash import poseidon as pos
from zkevm_tpu_torch.transcript import PoseidonTranscript

VECTORS = Path(__file__).resolve().parent.parent / "vectors" / "torch_port_mpt.json"
SPEC = pos.P128_POW5_T3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def recorded():
    return json.loads(VECTORS.read_text())["poseidon"]


def _encode(rows) -> torch.Tensor:
    width = len(rows[0])
    return ff.to_tensor(FR.encode_many([v for r in rows for v in r]).reshape(len(rows), width, ff.W), "cpu")


def _random_elems(rng, count):
    return [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(count)]


def test_constants_equal_reference():
    assert pos.generate_constants(SPEC) == jpos.generate_constants(jpos.P128_POW5_T3)
    assert (SPEC.t, SPEC.r_f, SPEC.r_p, SPEC.rate) == (3, 8, 56, 2)


def test_golden_equals_reference_golden(rng):
    for state in ([0, 0, 0], [FR_MOD - 1] * 3, _random_elems(rng, 3)):
        assert pos.permute_golden(SPEC, state) == jpos.permute_golden(jpos.P128_POW5_T3, state)
    for length in (0, 1, 4):
        msg = _random_elems(rng, length)
        assert pos.hash_golden(SPEC, msg) == jpos.hash_golden(jpos.P128_POW5_T3, msg)


def test_plain_permute_equals_golden(rng):
    states = [[0, 1, FR_MOD - 1], [0, 0, 0], [1, 1, 1]] + [_random_elems(rng, 3) for _ in range(3)]
    got = pos.permute(SPEC, _encode(states))
    assert [FR.decode_many(s) for s in got] == [pos.permute_golden(SPEC, s) for s in states]


def test_permute_equals_recorded_reference(recorded):
    got = pos.permute(SPEC, _encode(recorded["states"]))
    assert [FR.decode_many(s) for s in got] == recorded["permute"]


@pytest.mark.parametrize("length", ["1", "2", "3", "5"])
def test_hash_many_equals_recorded_reference_and_golden(recorded, length):
    msgs = recorded["messages"][length]
    got = FR.decode_many(pos.hash_many(SPEC, _encode(msgs)))
    assert got == recorded["hash_many"][length]
    assert got == [pos.hash_golden(SPEC, m) for m in msgs]


def test_trace_holds_every_round(rng):
    """Entry [i, p, r] is lane i of permutation p before round r, as the
    reference's PoseidonTable assignment computes it round by round."""
    rc, mds = pos.generate_constants(SPEC)
    half = SPEC.r_f // 2
    states = [[0, 0, 0], _random_elems(rng, 3)]
    tr = pos.permute_trace(SPEC, _encode(states))
    assert tuple(tr.shape) == (3, 2, 65, ff.W)
    for p_, s in enumerate(states):
        want = [list(s)]
        for r in range(SPEC.r_f + SPEC.r_p):
            full = r < half or r >= half + SPEC.r_p
            sb = [(s[i] + rc[r][i]) % FR_MOD for i in range(3)]
            sb = [pow(v, 5, FR_MOD) if (full or i == 0) else v for i, v in enumerate(sb)]
            s = [sum(mds[j][i] * sb[i] for i in range(3)) % FR_MOD for j in range(3)]
            want.append(s)
        got = [FR.decode_many(tr[:, p_, r]) for r in range(65)]
        assert got == want


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        pos.permute(SPEC, torch.zeros(2, 3, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        pos.hash_many(SPEC, torch.zeros(2, 8, dtype=torch.int32))
    with pytest.raises(ValueError):
        pos.permute_trace(SPEC, torch.zeros(1, 2, 3, 8, dtype=torch.int32))


def test_poseidon_transcript_equals_reference(rng):
    pts = [g1g.random_point(rng) for _ in range(2)]
    seq = [("point", pts[0]), ("scalar", FR_MOD + 5), ("point", None), ("challenge",),
           ("bytes", bytes(range(70))), ("scalar", 3), ("challenge",), ("challenge",),
           ("point", (FQ_MOD - 1, 2)), ("challenge",)]
    port, ref = PoseidonTranscript(), JPoseidonTranscript()
    got, want = [], []
    for op in seq:
        for tr, out in ((port, got), (ref, want)):
            if op[0] == "point":
                tr.common_point(op[1])
            elif op[0] == "scalar":
                tr.common_scalar(op[1])
            elif op[0] == "bytes":
                tr.common_bytes(op[1])
            else:
                out.append(tr.challenge())
    assert got == want
    # a point given as the port's (3, 8) tensor absorbs as its affine ints
    a, b = PoseidonTranscript(), PoseidonTranscript()
    a.common_point(group.from_affine_ints([pts[1]], "cpu")[0])
    b.common_point(pts[1])
    assert a.challenge() == b.challenge()


def test_nonzero_plain_equals_reference_is_zero(rng):
    words = rng.integers(0, 1 << 32, (64, 3, ff.W), dtype=np.uint64).astype(np.uint32)
    words[::4] = 0
    words[1::4, :, 1:] = 0
    t = ff.to_tensor(words, "cpu")
    assert torch.equal(ff.nonzero(t), torch.from_numpy((words != 0).any(axis=-1)))
    assert torch.equal(ff.nonzero(t), ~ff.is_zero(t))
