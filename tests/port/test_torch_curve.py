"""The port's G1 arithmetic, SRS and MSM (kernel C's plain path on the CPU)
against the JAX reference ``zkevm_tpu/ec`` and ``zkevm_tpu/kzg`` and the
host golden model; affine points compared exactly."""

import numpy as np
import pytest
import torch

from zkevm_tpu.ec import goldens as g, group as jgroup
from zkevm_tpu.kzg import ParamsKZG as JParamsKZG
from zkevm_tpu_torch import convert
from zkevm_tpu_torch.ec import group, msm
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.kzg import ParamsKZG


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scalars(ks):
    return ff.to_tensor(ff.words_from_ints(ks), "cpu")


def test_add_and_double_match_reference(rng):
    pts = [g.random_point(rng) for _ in range(8)] + [None, g.G1_GEN]
    qts = [g.random_point(rng) for _ in range(8)] + [g.G1_GEN, None]
    pts += [pts[0], pts[1]]  # same point (doubling path), opposite points
    qts += [pts[0], g.neg(pts[1])]
    P, Q = group.from_affine_ints(pts, "cpu"), group.from_affine_ints(qts, "cpu")
    JP, JQ = jgroup.from_affine_ints(pts), jgroup.from_affine_ints(qts)
    want = jgroup.to_affine_ints(jgroup.add(JP, JQ))
    assert group.to_affine_ints(group.add(P, Q)) == want == [g.add(a, b) for a, b in zip(pts, qts)]
    assert group.to_affine_ints(group.double(P)) == jgroup.to_affine_ints(jgroup.double(JP))
    # the Jacobian words equal the reference's limbs (same formulas)
    got = group.add(P, Q)
    jsum = jgroup.add(JP, JQ)
    for i, coord in enumerate((jsum.x, jsum.y, jsum.z)):
        np.testing.assert_array_equal(convert.words_to_limbs16(got[:, i]), np.asarray(coord))



@pytest.mark.parametrize("case", ["P+Q", "P+O", "O+P", "O+O", "P+P", "P+-P", "G+2G", "-P+P"])
def test_add_cases_match_golden(rng, case):
    """Each branch of the complete addition against the host golden."""
    p, q = g.random_point(rng), g.random_point(rng)
    lhs, rhs = {"P+Q": (p, q), "P+O": (p, None), "O+P": (None, p), "O+O": (None, None),
                "P+P": (p, p), "P+-P": (p, g.neg(p)), "G+2G": (g.G1_GEN, g.double(g.G1_GEN)),
                "-P+P": (g.neg(p), p)}[case]
    got = group.add(group.from_affine_ints([lhs], "cpu"), group.from_affine_ints([rhs], "cpu"))
    assert group.to_affine_ints(got) == [g.add(lhs, rhs)]


@pytest.mark.parametrize("case", ["P", "O", "G", "-P"])
def test_double_and_neg_match_golden(rng, case):
    p = g.random_point(rng)
    pt = {"P": p, "O": None, "G": g.G1_GEN, "-P": g.neg(p)}[case]
    jac = group.from_affine_ints([pt], "cpu")
    assert group.to_affine_ints(group.double(jac)) == [g.double(pt)]
    assert group.to_affine_ints(group.neg(jac)) == [g.neg(pt)]

def test_scalar_mul_matches_golden(rng):
    """Per-lane scalar multiplication, edge scalars and an identity base,
    against the reference's host golden (the reference's own device
    scalar_mul is cross-checked through unsafe_setup below)."""
    pts = [g.random_point(rng) for _ in range(4)] + [None]
    ks = [0, 1, 2, int(rng.integers(1, 1 << 62)) * g.R // (1 << 62) + 12345, g.R - 1]
    out = group.scalar_mul(group.from_affine_ints(pts, "cpu"), _scalars(ks))
    assert group.to_affine_ints(out) == [g.scalar_mul(p, k) for p, k in zip(pts, ks)]


def test_unsafe_setup_matches_reference():
    """unsafe_setup(4, tau=777) in both packages: per-lane scalar
    multiplication of the generator by the powers of tau."""
    params = ParamsKZG.unsafe_setup(4, tau=777, device="cpu")
    jparams = JParamsKZG.unsafe_setup(4, 777)
    assert group.to_affine_ints(params.g1_powers) == jgroup.to_affine_ints(jparams.g1_powers)
    assert group.to_affine_ints(params.g1_powers) == [
        g.scalar_mul(g.G1_GEN, pow(777, i, g.R)) for i in range(16)]
    assert params.s_g2 == jparams.s_g2
    # the reference's SRS arrays carried across
    p = jparams.g1_powers
    carried = convert.params_from_numpy(np.asarray(p.x), np.asarray(p.y), np.asarray(p.z),
                                        jparams.g2, jparams.s_g2, device="cpu")
    assert group.to_affine_ints(carried.g1_powers) == group.to_affine_ints(params.g1_powers)


def test_msm_edge_cases_match_golden(rng):
    """Against the reference's host golden MSM (``zkevm_tpu.ec.goldens``),
    which its own MSM tests hold the device engines to."""
    n = 16
    pts = [g.random_point(rng) for _ in range(n)]
    ks = [int.from_bytes(rng.bytes(32), "little") % g.R for _ in range(n)]
    ks[0] = 0  # zero scalar
    pts[1] = None  # identity base
    pts[5] = pts[6] = pts[4]  # repeated bases, equal digits: the doubling case
    ks[5] = ks[4]
    assert group.to_affine_ints(msm.msm(group.from_affine_ints(pts, "cpu"), _scalars(ks))) == [g.msm(pts, ks)]


def test_msm_skewed_digits_match_golden(rng):
    n = 33
    pts = [g.random_point(rng) for _ in range(n)]
    ks = [int(rng.integers(0, 2)) for _ in range(n)]  # 0/1 scalars: one crowded bucket
    got = msm.msm(group.from_affine_ints(pts, "cpu"), _scalars(ks))
    assert group.to_affine_ints(got) == [g.msm(pts, ks)]
