"""The port's PLONK prover and verifier (plain paths on the CPU) against the
JAX reference: the K=5 toy proof and a two-phase toy proof field by field
against the reference proofs recorded in
``tests/vectors/torch_port_toy_proof.json`` (which
``tests/port/test_torch_vectors.py`` holds against the live reference), each
package's verifier on the other's proof, a tampered eval rejected, the
evaluation helpers, and the KeccakTable assignment at k=12 column by
column."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zkevm_tpu.circuits import keccak_table as jkt
from zkevm_tpu.circuits.tables import Challenges as JChallenges
from zkevm_tpu.ec import pairing as jpr
from zkevm_tpu.ff import FR as JFR
from zkevm_tpu.kzg import ParamsKZG as JParamsKZG
from zkevm_tpu.plonk import ConstraintSystem as JConstraintSystem
from zkevm_tpu.plonk import prover as jprover
from zkevm_tpu.plonk.keygen import VerifyingKey as JVerifyingKey
from zkevm_tpu.plonk.verifier import verify_proof as jverify_proof
from zkevm_tpu.poly.domain import Domain as JDomain
from zkevm_tpu_torch import convert
from zkevm_tpu_torch.circuits import keccak_table as kt, toy
from zkevm_tpu_torch.circuits.tables import Challenges
from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.kzg import ParamsKZG
from zkevm_tpu_torch.plonk import Assignment, ConstraintSystem, create_proof, keygen, verify_proof
from zkevm_tpu_torch.plonk.prover import Proof, eval_polys_at, proof_fields, proof_to_json

VECTORS = Path(__file__).resolve().parent.parent / "vectors" / "torch_port_toy_proof.json"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vectors():
    return json.loads(VECTORS.read_text())


@pytest.fixture(scope="module")
def toy_run(vectors):
    """The port proves the toy circuit on the CPU (module-scoped: slow)."""
    torch.set_num_threads(1)
    params = ParamsKZG.unsafe_setup(vectors["k"], tau=vectors["tau"], device="cpu")
    cs, cols = toy.build_toy(ConstraintSystem)
    asg = toy.assign_toy(cs, cols, Assignment)
    pk = keygen(params, cs, toy.fixed_only(cs, asg, Assignment))
    proof = create_proof(params, pk, [], asg, seed=vectors["toy"]["seed"])
    return params, cs, cols, pk, proof


def _reference_verifier(vectors, name, build):
    """The reference's verifier for circuit ``name``: its own
    ConstraintSystem, the recorded verifying-key commitments, host G2."""
    jcs, _ = build(JConstraintSystem)
    ref = vectors[name]
    vk = JVerifyingKey(
        jcs, JDomain.new(jcs.gate_degree() + 1, vectors["k"]),
        [tuple(p) for p in ref["fixed_commitments"]],
        [tuple(p) for p in ref["sigma_commitments"]],
    )
    params = JParamsKZG(k=vectors["k"], g1_powers=None, g2=jpr.G2_GEN,
                        s_g2=jpr.g2_scalar_mul(jpr.G2_GEN, vectors["tau"]))
    return params, vk


def test_toy_proof_equals_reference(vectors, toy_run):
    params, cs, cols, pk, proof = toy_run
    ref = vectors["toy"]
    assert [list(p) for p in pk.vk.fixed_commitments] == ref["fixed_commitments"]
    assert [list(p) for p in pk.vk.sigma_commitments] == ref["sigma_commitments"]
    got = proof_to_json(proof)
    for field in got:
        assert got[field] == ref["proof"][field], field


def test_verifiers_accept_each_others_proofs(vectors, toy_run):
    params, cs, cols, pk, proof = toy_run
    # the port's verifier on the reference's recorded proof
    ref_proof = Proof(**proof_fields(vectors["toy"]["proof"]))
    assert verify_proof(params, pk.vk, [], ref_proof)
    # the reference's verifier on the port's proof
    jparams, jvk = _reference_verifier(vectors, "toy", toy.build_toy)
    assert jverify_proof(jparams, jvk, [], jprover.Proof(**proof_fields(proof_to_json(proof))))


def test_tampered_eval_rejected(toy_run):
    params, cs, cols, pk, proof = toy_run
    bad = copy.deepcopy(proof)
    bad.evals[0] = (bad.evals[0] + 1) % FR_MOD
    assert not verify_proof(params, pk.vk, [], bad)


def test_bad_witness_rejected(toy_run):
    params, cs, cols, pk, proof = toy_run
    with pytest.raises(ValueError):
        create_proof(params, pk, [], toy.assign_toy(cs, cols, Assignment, break_lookup=True), seed=1)


def test_two_phase_proof_equals_reference(vectors, toy_run):
    params = toy_run[0]
    ref = vectors["two_phase"]
    cs, cols = toy.build_two_phase(ConstraintSystem)
    fixed, witness = toy.two_phase_witness(cs, cols, Assignment)
    pk = keygen(params, cs, fixed)
    proof = create_proof(params, pk, [], witness, seed=ref["seed"])
    assert proof_to_json(proof) == ref["proof"]
    assert verify_proof(params, pk.vk, [], proof)
    jparams, jvk = _reference_verifier(vectors, "two_phase", toy.build_two_phase)
    assert jverify_proof(jparams, jvk, [], jprover.Proof(**proof_fields(ref["proof"])))


def test_eval_polys_at_matches_reference(rng):
    stack = np.stack([[JFR.encode(int(rng.integers(0, 1 << 62))) for _ in range(32)] for _ in range(3)])
    x = int(rng.integers(0, 1 << 62))
    assert eval_polys_at(convert.limbs16_to_words(stack, device="cpu"), x) == jprover.eval_polys_at(stack, x)


def test_keccak_table_assignment_matches_reference():
    """KeccakTable at k=12, both packages' host witness column by column."""
    n = 1 << 12
    jcs, cs = JConstraintSystem(), ConstraintSystem()
    jcfg = jkt.configure(jcs, JChallenges.configure(jcs))
    cfg = kt.configure(cs, Challenges.configure(cs))
    assert (len(cs.advice_columns), len(cs.fixed_columns), len(cs.gates), cs.gate_degree()) == (
        len(jcs.advice_columns), len(jcs.fixed_columns), len(jcs.gates), jcs.gate_degree())
    assert kt.num_perms(cs, n) == jkt.num_perms(jcs, n) == 2
    for msgs in ([bytes(range(200))], [b"abc", bytes(135)], [b""]):
        jwit = jkt.assign(jcs, jcfg, n, msgs)
        wit = kt.assign(cs, cfg, n, msgs)
        jwit.fill_phase1(0x107, 0x100)
        wit.fill_phase1(0x107, 0x100)
        carried = convert.columns_from_numpy(jwit.asg.cols, cs)
        assert len(carried) == len(wit.asg.cols)
        for col, words in wit.asg.cols.items():
            np.testing.assert_array_equal(words, carried[col], err_msg=repr(col))
        np.testing.assert_array_equal(wit.digest_bytes, jwit.digest_bytes)
