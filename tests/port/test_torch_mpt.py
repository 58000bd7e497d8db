"""The port's state-trie slice on the CPU against the JAX reference: the
zktrie (roots and proofs at depth 8, one update at depth 248), the MPT
circuit over the PoseidonTable (configuration, ``poseidon_states`` and the
depth-8, k=12 witness column by column against the reference's host
``pt.assign`` + ``mpt.assign``), the recorded witness digest, the verifying
key's fingerprint, the proof artifacts, and the port's verifier on the
reference's recorded proof under a PoseidonTranscript
(``tests/vectors/torch_port_mpt.json``). Every comparison is exact."""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zkevm_tpu.circuits import mpt_circuit as jmpt, poseidon_table as jpt
from zkevm_tpu.plonk import Assignment as JAssignment, ConstraintSystem as JConstraintSystem
from zkevm_tpu.plonk import prover as jprover
from zkevm_tpu.plonk.keygen import VerifyingKey as JVerifyingKey
from zkevm_tpu.poly.domain import Domain as JDomain
from zkevm_tpu.prover import artifacts as jartifacts
from zkevm_tpu.state.zktrie import ZkTrie as JZkTrie
from zkevm_tpu_torch import convert
from zkevm_tpu_torch.circuits import mpt_circuit as mpt, mpt_small as ms, poseidon_table as pt
from zkevm_tpu_torch.ec import pairing as pr
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.kzg import ParamsKZG
from zkevm_tpu_torch.plonk import Assignment, ConstraintSystem, verify_proof
from zkevm_tpu_torch.plonk.keygen import VerifyingKey
from zkevm_tpu_torch.plonk.prover import Proof, proof_fields
from zkevm_tpu_torch.poly.domain import Domain
from zkevm_tpu_torch.prover import artifacts
from zkevm_tpu_torch.state import ZkTrie
from zkevm_tpu_torch.transcript import PoseidonTranscript

VECTORS = Path(__file__).resolve().parent.parent / "vectors" / "torch_port_mpt.json"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vectors():
    return json.loads(VECTORS.read_text())


@pytest.fixture(scope="module")
def reference_case():
    """The reference's small case: its circuit, updates and host witness."""
    cs, ptcfg, mcfg = ms.build(JConstraintSystem, jpt, jmpt)
    ups = ms.updates(JZkTrie, jmpt)
    states = jmpt.poseidon_states(ups, ms.DEPTH)
    asg = JAssignment(cs, ms.N)
    jpt.assign(cs, ptcfg, ms.N, states, asg)
    jmpt.assign(cs, mcfg, ms.N, ups, asg)
    return cs, ups, states, asg


@pytest.fixture(scope="module")
def port_case():
    """The port's small case on the CPU (the plain path of kernel E)."""
    torch.set_num_threads(1)
    cs, ptcfg, mcfg = ms.build(ConstraintSystem, pt, mpt)
    ups = ms.updates(ZkTrie, mpt)
    states = mpt.poseidon_states(ups, ms.DEPTH, device="cpu")
    asg = Assignment(cs, ms.N)
    pt.assign(cs, ptcfg, ms.N, states, asg, device="cpu")
    mpt.assign(cs, mcfg, ms.N, ups, asg, device="cpu")
    return cs, ptcfg, mcfg, ups, states, asg


def _proof_of(vectors) -> Proof:
    return Proof(**proof_fields(vectors["proof"]))


def test_trie_roots_and_proofs_equal_reference(rng):
    port, ref = ZkTrie(depth=8), JZkTrie(depth=8)
    keys = [[int(rng.integers(0, 1 << 62)), i] for i in range(6)]
    for i, key in enumerate(keys):
        vals = [i * 1000 + 1, i]
        assert port.update(key, vals) == ref.update(key, vals)
        assert port.root == ref.root
    port.update(keys[2], None)
    ref.update(keys[2], None)
    assert port.root == ref.root
    for key in keys + [[7, 7]]:
        p, r = port.prove(key), ref.prove(key)
        assert (p.key_hash, p.value_hash, p.siblings) == (r.key_hash, r.value_hash, r.siblings)
        assert port.verify(p, port.root)


def test_trie_update_depth_248_equals_reference():
    port, ref = ZkTrie(), JZkTrie()
    assert port.depth == 248
    port.update([0xAAAA, 5], [111, 0])
    ref.update([0xAAAA, 5], [111, 0])
    u, ju = mpt.apply_update(port, 0xBBBB, 7, 222, 1), jmpt.apply_update(ref, 0xBBBB, 7, 222, 1)
    assert (u.kh, u.siblings, u.root_old, u.root_new) == (ju.kh, ju.siblings, ju.root_old, ju.root_new)
    assert port.verify(port.prove([0xBBBB, 7]), port.root)


def test_configuration_equals_reference(port_case, reference_case):
    cs, jcs = port_case[0], reference_case[0]
    assert (len(cs.advice_columns), len(cs.fixed_columns), cs.gate_degree()) == (
        len(jcs.advice_columns), len(jcs.fixed_columns), jcs.gate_degree()) == (22, 14, 8)
    assert [g.name for g in cs.gates] == [g.name for g in jcs.gates]
    assert [[repr(p) for p in g.polys] for g in cs.gates] == [[repr(p) for p in g.polys] for g in jcs.gates]
    assert [lk.name for lk in cs.lookups] == [lk.name for lk in jcs.lookups]
    assert pt.capacity(cs, 1 << 20) == jpt.capacity(jcs, 1 << 20) == 16131
    assert mpt.capacity(cs, 1 << 20, 248) == jmpt.capacity(jcs, 1 << 20, 248) == 4128


def test_poseidon_states_equal_reference(port_case, reference_case):
    assert port_case[4] == reference_case[2]
    assert len(port_case[4]) == 19 + 21  # an insert and an update at depth 8


def test_witness_equals_reference_column_by_column(port_case, reference_case):
    cs, asg = port_case[0], port_case[5]
    carried = convert.columns_from_numpy(reference_case[3].cols, cs)
    assert len(carried) == len(asg.cols)
    for col, words in asg.cols.items():
        np.testing.assert_array_equal(words, carried[col], err_msg=repr(col))
    back = convert.columns_to_reference(asg, reference_case[0])
    for col, limbs in reference_case[3].cols.items():
        np.testing.assert_array_equal(back[col], limbs, err_msg=repr(col))


def test_witness_equals_recorded(port_case, vectors):
    ups, asg = port_case[3], port_case[5]
    assert [[u.root_old, u.root_new] for u in ups] == vectors["roots"]
    assert [u.kh for u in ups] == vectors["key_hashes"]
    assert asg.digest() == vectors["witness_digest"]


def test_table_rejects_too_many_states(port_case):
    cs, ptcfg = port_case[0], port_case[1]
    with pytest.raises(ValueError):
        pt.assign(cs, ptcfg, ms.N, [[0, 0, 0]] * (pt.capacity(cs, ms.N) + 1), device="cpu")


def test_vk_fingerprint_equals_reference(port_case, reference_case, vectors):
    """The port's fingerprint of the circuit with the recorded verifying-key
    commitments equals the reference's (the commitments themselves are
    held to the reference's keygen on the card, by chip_smoke.py)."""
    cs, jcs = port_case[0], reference_case[0]
    fixed = [tuple(p) for p in vectors["fixed_commitments"]]
    vk = VerifyingKey(cs, Domain.new(cs.gate_degree() + 1, ms.K), fixed, [])
    assert artifacts.vk_fingerprint(vk) == vectors["vk_fingerprint"]
    jvk = JVerifyingKey(jcs, JDomain.new(jcs.gate_degree() + 1, ms.K), fixed, [])
    assert jartifacts.vk_fingerprint(jvk) == vectors["vk_fingerprint"]


def test_proof_bytes_equal_reference(vectors, tmp_path):
    proof = _proof_of(vectors)
    raw = artifacts.proof_to_bytes(proof)
    assert raw == jartifacts.proof_to_bytes(jprover.Proof(**proof_fields(vectors["proof"])))
    assert artifacts.proof_from_bytes(raw) == proof
    path = str(tmp_path / "proof.json")
    artifacts.dump_proof(path, proof)
    assert artifacts.load_proof(path) == proof
    calls = []
    assert artifacts.load_or_gen_proof(path, lambda: calls.append(1)) == proof and not calls
    with pytest.raises(ValueError):
        artifacts.proof_from_bytes(raw[:-1])


def _verifier_params(vectors) -> ParamsKZG:
    """The verifier reads only the G2 side of the SRS; the G1 powers are a
    placeholder of the right shape."""
    k = vectors["k"]
    return ParamsKZG(k=k, g1_powers=torch.zeros(1 << k, 3, ff.W, dtype=torch.int32), g2=pr.G2_GEN,
                     s_g2=pr.g2_scalar_mul(pr.G2_GEN, vectors["tau"]))


def test_port_verifier_accepts_recorded_proof(port_case, vectors):
    cs = port_case[0]
    vk = VerifyingKey(cs, Domain.new(cs.gate_degree() + 1, ms.K),
                      [tuple(p) for p in vectors["fixed_commitments"]], [])
    params = _verifier_params(vectors)
    proof = _proof_of(vectors)
    assert verify_proof(params, vk, [], proof, transcript=PoseidonTranscript())
    bad = copy.deepcopy(proof)
    bad.evals[0] = (bad.evals[0] + 1) % FR_MOD
    assert not verify_proof(params, vk, [], bad, transcript=PoseidonTranscript())
