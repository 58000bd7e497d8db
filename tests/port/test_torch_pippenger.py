"""The port's Pippenger MSM (kernel G's plain path on the CPU,
``zkevm_tpu_torch/ec/pippenger.py``) against the reference's
``zkevm_tpu/ec/pippenger.py``: ``msm_t``'s recorded results
(``tests/vectors/torch_port_kzg.json``) and the host golden sum, and
``signed_digits`` live; affine points compared exactly."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zkevm_tpu.ec import pippenger as jpip
from zkevm_tpu.ff import limbs
from zkevm_tpu_torch.ec import goldens as g, group, msm as msmmod, pippenger as pip
from zkevm_tpu_torch.ff import field as ff

VEC = json.loads((Path(__file__).resolve().parents[1] / "vectors" / "torch_port_kzg.json").read_text())
MSM = VEC["msm"]
POINTS = [None if p is None else tuple(p) for p in MSM["points"]]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    """sum_i s_i P_i by the host golden model, for each n the cases use."""
    return {n: g.msm(POINTS[:n], MSM["scalars"][:n]) for n in {c["n"] for c in MSM["cases"]}}


def _ids(case):
    return f"n{case['n']}-c{case['c']}-{'signed' if case['signed'] else 'unsigned'}-lanes{case['sublanes']}"


@pytest.mark.parametrize("i", range(len(MSM["cases"])), ids=[_ids(c) for c in MSM["cases"]])
def test_msm_matches_reference(golden, i):
    """Zero scalars, scalars of 2^255 and 2^256 - 1, the identity and a
    repeated base with an equal scalar (the doubling case) are among the
    inputs; n = 96 with 64 sublanes halves Lw to 32."""
    case = MSM["cases"][i]
    n = case["n"]
    pts = group.from_affine_ints(POINTS[:n], "cpu")
    scalars = ff.to_tensor(ff.words_from_ints(MSM["scalars"][:n]), "cpu")
    got = pip.msm(pts, scalars, c=case["c"], sublanes=case["sublanes"], signed=case["signed"])
    want = VEC["msm_results"][i]
    assert group.to_affine_ints(got) == [None if want is None else tuple(want)] == [golden[n]]


def test_engine_matches_msm():
    """PippengerMSM (the loaded SRS's engine) is msm at the reference's
    defaults: c = 4, 1024 sublanes, unsigned."""
    pts = group.from_affine_ints(POINTS[:64], "cpu")
    scalars = ff.to_tensor(ff.words_from_ints(MSM["scalars"][:64]), "cpu")
    assert torch.equal(pip.PippengerMSM(pts)(scalars), pip.msm(pts, scalars))
    assert pip.lane_width(96, 64) == 32 and pip.lane_width(96, 1024) == 96


@pytest.mark.parametrize("c", [3, 4, 5])
def test_signed_digits_match_reference(c):
    scalars = MSM["scalars"]
    mags, signs = pip.signed_digits(ff.to_tensor(ff.words_from_ints(scalars), "cpu"), c)
    jmags, jsigns = jpip.signed_digits(limbs.limbs_from_ints(scalars), c)
    np.testing.assert_array_equal(mags.numpy(), np.asarray(jmags))
    np.testing.assert_array_equal(signs.numpy(), np.asarray(jsigns))
    # each scalar is recovered from its signed digits
    w = np.where(signs.numpy().astype(bool), -mags.numpy().astype(object), mags.numpy().astype(object))
    assert [sum(int(w[j, i]) << (c * j) for j in range(w.shape[0])) for i in range(len(scalars))] == scalars


@pytest.mark.parametrize("c,signed", [(9, False), (10, True)])
def test_segmented_fold_matches_golden(golden, c, signed):
    """Windows wider than LANE_MAX_C go through C's sorted accumulation, and
    their buckets fold in levels of segments (c = 9: 512 buckets in 64
    segments of 8, then pairs; signed c = 10: 513 buckets in 65, then 33,
    17, 9, 5, 3, 2, 1 pairs, each level's last segment ragged)."""
    assert c > pip.LANE_MAX_C
    parts = [p for p, _ in msmmod.fold_levels(pip.num_buckets(c, signed))]
    assert parts == ([65, 33, 17, 9, 5, 3, 2, 1] if signed else [64, 32, 16, 8, 4, 2, 1])
    pts = group.from_affine_ints(POINTS[:64], "cpu")
    scalars = ff.to_tensor(ff.words_from_ints(MSM["scalars"][:64]), "cpu")
    got = pip.msm(pts, scalars, c=c, sublanes=4, signed=signed)
    assert group.to_affine_ints(got) == [golden[64]]


@pytest.mark.parametrize("signed", [False, True])
def test_c16_fold_matches_golden(signed):
    """At the mesh engine's c = 16 a window's 65,536 buckets fold in 8,192
    segments of 8, then in 13 levels of pairs (signed: 32,769 buckets, the
    last segment of a level ragged); one window of 16-bit scalars keeps the
    plain fold over every bucket to seconds."""
    c, nb = 16, pip.num_buckets(16, signed)
    levels = msmmod.fold_levels(nb)
    assert levels[0] == ((4097, 3) if signed else (8192, 3)) and levels[-1] == (1, 1)
    assert len(levels) == 14 and all(log_l == 1 for _, log_l in levels[1:])
    low = [s % (1 << c) for s in MSM["scalars"][:64]]
    pts = group.from_affine_ints(POINTS[:64], "cpu")
    scalars = ff.to_tensor(ff.words_from_ints(low), "cpu")
    got = pip.msm(pts, scalars, c=c, num_bits=c, sublanes=4, signed=signed)
    assert group.to_affine_ints(got) == [g.msm(POINTS[:64], low)]
