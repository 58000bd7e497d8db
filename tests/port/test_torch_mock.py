"""The port's MockProver on the CPU (the plain paths of kernels A and F)
against the JAX reference: the failure lists of the depth-8, k=12 state-trie
witness, honest and with the four tampers of the reference's
``tests/test_mpt_circuit.py``, against the reference's lists recorded in
``tests/vectors/torch_port_mpt.json``; the toy circuit's broken gate,
lookup and copy against the live reference (K=5); the row-restricted
evaluation, a vector gate against the live reference (K=5) and the
lookup row ids. Every comparison is exact."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zkevm_tpu.circuits import mpt_circuit as jmpt, poseidon_table as jpt
from zkevm_tpu.plonk import Assignment as JAssignment, ConstraintSystem as JConstraintSystem
from zkevm_tpu.plonk import MockProver as JMockProver
from zkevm_tpu.plonk import mock as jmock
from zkevm_tpu_torch.circuits import mpt_circuit as mpt, mpt_small as ms
from zkevm_tpu_torch.circuits import poseidon_table as pt, toy
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.plonk import Assignment, ConstraintSystem, MockProver
from zkevm_tpu_torch.plonk import mock
from zkevm_tpu_torch.plonk.expr import EvalContext
from zkevm_tpu_torch.plonk.prover import dense_ranks
from zkevm_tpu_torch.state import ZkTrie

VECTORS = Path(__file__).resolve().parent.parent / "vectors" / "torch_port_mpt.json"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def recorded_mock():
    return json.loads(VECTORS.read_text())["mock"]


@pytest.fixture(scope="module")
def mpt_case():
    torch.set_num_threads(1)
    cs, ptcfg, mcfg = ms.build(ConstraintSystem, pt, mpt)
    ups = ms.updates(ZkTrie, mpt)
    asg = Assignment(cs, ms.N)
    pt.assign(cs, ptcfg, ms.N, mpt.poseidon_states(ups, ms.DEPTH, device="cpu"), asg, device="cpu")
    mpt.assign(cs, mcfg, ms.N, ups, asg, device="cpu")
    return cs, mcfg, asg


def _copy(asg):
    out = Assignment(asg.cs, asg.n)
    out.cols = {c: a.copy() for c, a in asg.cols.items()}
    return out


@pytest.mark.parametrize("case", ["honest", *ms.TAMPERS])
def test_mpt_failures_equal_recorded_reference(mpt_case, recorded_mock, case):
    cs, mcfg, asg = mpt_case
    if case != "honest":
        asg = _copy(asg)
        ms.TAMPERS[case](asg, mcfg, ms.DEPTH)
    got = ms.failures_to_json(MockProver(cs, asg, device="cpu").verify())
    assert got == recorded_mock[case]
    assert (got == []) == (case == "honest")


def _toy_witnesses(ConstraintSystem, Assignment):
    cs, cols = toy.build_toy(ConstraintSystem)
    good = toy.assign_toy(cs, cols, Assignment)
    bad_lookup = toy.assign_toy(cs, cols, Assignment, break_lookup=True)
    bad_gate = toy.assign_toy(cs, cols, Assignment)
    bad_gate.set_int(cols[5], 2, 1234)  # c[2] breaks mul_add (and no copy)
    bad_copy = toy.assign_toy(cs, cols, Assignment)
    bad_copy.set_int(cols[5], 7, 99)  # c[7] != c[0]
    return cs, {"good": good, "lookup": bad_lookup, "gate": bad_gate, "copy": bad_copy}


def test_toy_failures_equal_live_reference():
    cs, port = _toy_witnesses(ConstraintSystem, Assignment)
    jcs, ref = _toy_witnesses(JConstraintSystem, JAssignment)
    for name in port:
        got = ms.failures_to_json(MockProver(cs, port[name], device="cpu").verify())
        want = ms.failures_to_json(JMockProver(jcs, ref[name]).verify())
        assert got == want, name
        assert (got == []) == (name == "good"), name


def test_row_restricted_evaluation_equals_full(mpt_case, rng):
    """set_rows gathers (rows + rot) mod n: the same values as evaluating
    every row and then picking the rows."""
    cs, _, asg = mpt_case
    cols = {c: ff.to_tensor(a, "cpu") for c, a in asg.cols.items()}
    ctx = EvalContext(cols, [], "cpu")
    rows = np.concatenate([[0, 1, ms.N - 1], rng.integers(0, ms.N, 29)])
    for gate in cs.gates:
        for poly in gate.polys:
            full = poly.evaluate(ctx).expand(ms.N, ff.W)
            ctx.set_rows(rows)
            part = poly.evaluate(ctx).expand(len(rows), ff.W)
            ctx.set_rows(None)
            assert torch.equal(part, full[torch.from_numpy(rows)])


def test_peel_selectors_equals_reference(mpt_case):
    cs = mpt_case[0]
    jcs = ms.build(JConstraintSystem, jpt, jmpt)[0]
    for gate, jgate in zip(cs.gates, jcs.gates):
        for poly, jpoly in zip(gate.polys, jgate.polys):
            sels, rest = mock._peel_selectors(poly)
            jsels, jrest = jmock._peel_selectors(jpoly)
            assert repr(sels) == repr(jsels) and repr(rest) == repr(jrest)


def test_row_key_ids_membership_equals_np_unique(rng):
    """dense_ranks gives np.unique's inverse (rows read most significant
    word first), so lookup membership is the reference's."""
    table = [rng.integers(0, 4, (300, ff.W), dtype=np.uint64).astype(np.uint32) for _ in range(2)]
    table[0][5, 7] = 0xFFFFFFFF  # a high word whose sign bit is set
    inputs = [t[rng.integers(0, 300, 300)].copy() for t in table]
    inputs[0][::7, 3] += 5  # some rows not in the table
    active = 290
    tab = np.concatenate([t[:active] for t in table], axis=1)
    inp = np.concatenate([i[:active] for i in inputs], axis=1)
    cat = np.concatenate([tab, inp])
    _, inv = np.unique(cat[:, ::-1], axis=0, return_inverse=True)
    np.testing.assert_array_equal(dense_ranks(cat), inv.reshape(-1))
    tab_ids, inp_ids = mock._row_key_ids(table, inputs, active)
    misses = np.nonzero(~np.isin(inp_ids, tab_ids))[0]
    assert misses.size > 0
    inv = inv.reshape(-1)
    np.testing.assert_array_equal(misses, np.nonzero(~np.isin(inv[active:], inv[:active]))[0])


def _vector_case(ConstraintSystem, Assignment, tamper: bool):
    """A K=5 circuit with one vector gate: lane z of group b equals lane
    z - 1 of group a on the next row (a row and a lane roll), gated by a
    fixed selector. ``tamper`` breaks one lane of one row."""
    cs = ConstraintSystem()
    q = cs.fixed_column()
    a = cs.advice_group("a", 4)
    b = cs.advice_group("b", 4)
    cs.create_vector_gate("roll", [q.cur() * (b.q(0, 0) - a.q(1, 1))], 4)
    asg = Assignment(cs, toy.N)
    for r in range(8):
        asg.set_int(q, r, 1)
        for z in range(4):
            asg.set_int(a.columns[z], r + 1, 10 * r + z)
            asg.set_int(b.columns[z], r, 10 * r + (z - 1) % 4)
    if tamper:
        asg.set_int(b.columns[2], 5, 7)
    return cs, asg


@pytest.mark.parametrize("tamper", [False, True])
def test_vector_gate_failures_equal_live_reference(tamper):
    cs, asg = _vector_case(ConstraintSystem, Assignment, tamper)
    jcs, jasg = _vector_case(JConstraintSystem, JAssignment, tamper)
    got = ms.failures_to_json(MockProver(cs, asg, device="cpu").verify())
    assert got == ms.failures_to_json(JMockProver(jcs, jasg).verify())
    assert got == ([["gate", "roll[lanes [2]]", 0, [5]]] if tamper else [])
