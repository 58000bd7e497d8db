"""The port's single-point KZG opening (``open_single``, kernel H's plain
path on the CPU) against the reference's ``zkevm_tpu/kzg/params.py``, at
K = 4 and tau = 0xACE0FBA5E as ``tests/test_kzg.py`` opens: the value
against ``poly/goldens.poly_eval`` and the recorded reference value, the
proof point against the recorded reference proof, and both packages'
``verify_single`` on it."""

import json
import types
from pathlib import Path

import pytest
import torch

from zkevm_tpu.ec import group as jgroup
from zkevm_tpu.kzg import verify_single as jverify_single
from zkevm_tpu.poly import goldens as pg
from zkevm_tpu_torch.ec import group
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.kzg import ParamsKZG, open_single, verify_single
from zkevm_tpu_torch.kzg import params as kp
from zkevm_tpu_torch.poly import ntt as nt

VEC = json.loads((Path(__file__).resolve().parents[1] / "vectors" / "torch_port_kzg.json").read_text())
OPEN = VEC["open"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def opened():
    params = ParamsKZG.unsafe_setup(OPEN["k"], tau=OPEN["tau"], device="cpu")
    coeffs = ff.to_tensor(FR.encode_many(OPEN["coeffs"]), "cpu")
    value, proof = open_single(params, nt.ntt(coeffs), OPEN["z"])
    return params, params.commit(coeffs), value, proof


def test_open_single_matches_reference(opened):
    params, commitment, value, proof = opened
    ref = VEC["open_result"]
    assert value == pg.poly_eval(OPEN["coeffs"], OPEN["z"]) == ref["value"]
    assert group.to_affine_ints(proof) == [tuple(ref["proof"])]
    assert group.to_affine_ints(commitment) == [tuple(ref["commitment"])]


def test_both_verifiers_accept_and_reject(opened):
    params, commitment, value, proof = opened
    z = OPEN["z"]
    assert verify_single(params, commitment, z, value, proof)
    assert not verify_single(params, commitment, z, value + 1, proof)
    # the reference's verifier reads only s_g2 of its params
    jparams = types.SimpleNamespace(s_g2=params.s_g2)
    jc, jw = (jgroup.from_affine_ints(group.to_affine_ints(p)) for p in (commitment, proof))
    assert jverify_single(jparams, jc, z, value, jw)
    assert not jverify_single(jparams, jc, z, value + 1, jw)


def test_open_quotient_definition():
    """The plain open_quotient against its definition on host ints."""
    rng = torch.Generator().manual_seed(3)
    vals = [[int(v) % FR.modulus for v in torch.randint(0, 1 << 62, (5,), generator=rng)] for _ in range(3)]
    f, xs, d = (ff.to_tensor(FR.encode_many(v), "cpu") for v in vals)
    scale = 123456789
    fz, q = kp.open_quotient(f, xs, d, scale)
    p = FR.modulus
    want = scale * sum(a * b * c for a, b, c in zip(*vals)) % p
    assert FR.decode(fz) == want
    assert FR.decode_many(q) == [(a - want) * c % p for a, c in zip(vals[0], vals[2])]
