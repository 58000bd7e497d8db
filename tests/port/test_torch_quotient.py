"""The quotient evaluator (``zkevm_tpu_torch/plonk/quotient.py``): the
register program that kernel M interprets, run by its plain version on the
CPU, against the per-node tree walk (``h_part_by_nodes``, the port's
``_h_part`` before kernel M), against the reference's ``_h_part`` fold live
(the toy circuits and a hand-made circuit) and against the reference's fold
recorded in ``tests/vectors/torch_port_quotient.json`` (the KeccakTable and
the depth-8 MPT constraint lists), all at 16 rows, word for word. The
hand-made circuit covers rotations that wrap at rows 0 and n - 1 in both
directions, group rolls, ``DomainX``, a challenge, constants >= r and
subtrees shared inside and across constraints."""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zkevm_tpu.plonk import ConstraintSystem as JConstraintSystem
from zkevm_tpu.plonk import expr as jex
from zkevm_tpu_torch import kernels
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.plonk import ConstraintSystem, expr as ex, quotient as q
from zkevm_tpu_torch.plonk import prover as prv
from zkevm_tpu_torch.plonk.protocol import build_protocol

ROOT = Path(__file__).resolve().parents[2]
LIVE = ("toy", "two_phase", "handmade")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rec():
    spec = importlib.util.spec_from_file_location(
        "record_torch_vectors", ROOT / "scripts" / "record_torch_vectors.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def vectors(rec):
    return json.loads(rec.QUOTIENT_OUT.read_text())


def build_handmade(ConstraintSystem, ex):
    """A circuit of either package (its ConstraintSystem and expr module)
    whose constraints reach every instruction of the quotient program."""
    cs = ConstraintSystem()
    q_ = cs.fixed_column()
    a, b = cs.advice_column(), cs.advice_column()
    g, h = cs.advice_group("g", 4), cs.advice_group("h", 4)
    r = cs.challenge_usable_after(0)
    c = cs.advice_column(phase=1)
    big = ex.Const(FR_MOD + 5)  # a constant >= r
    shared = a.next() * b.rot(-1) + big  # read by three constraints and by lanes
    lanes = g.q(1, 1) * h.q(-1, -1) + g.q(0, 5)  # read twice in one vector constraint
    cs.create_gate("rot", [q_.cur() * (a.rot(3) - b.rot(-2)) + shared,
                           shared * r.expr() - c.cur() + ex.DomainX() * ex.Const(-3)])
    cs.create_vector_gate("vec", [q_.cur() * lanes - lanes * shared + ex.DomainX(),
                                  g.q(-3, 2) - a.cur() * shared], 4)
    return cs


def circuit(rec, name: str, package: str):
    if name == "handmade":
        return build_handmade(*((JConstraintSystem, jex) if package == "jax" else (ConstraintSystem, ex)))
    return rec.quotient_circuit(name, package)


def port_case(rec, name: str, inp: dict | None = None):
    """(protocol, columns, part_vals, domain_x, challenges, inputs) of a
    case on the CPU, from the recording script's inputs."""
    cs = circuit(rec, name, "torch")
    inp = inp or rec.quotient_inputs(name, cs)
    prot = build_protocol(cs, 1 << inp["k"], inp["theta"], inp["beta"], inp["gamma"])
    cols = rec.quotient_columns(prot.constraints)
    assert [rec.column_key(c) for c in cols] == inp["columns"]
    values, domain_x = rec.quotient_values(inp)
    part_vals = ff.to_tensor(np.stack([FR.encode_many(v) for v in values]), "cpu")
    ch = [FR.const(v, "cpu") for v in inp["challenges"]]
    return prot, cols, part_vals, ff.to_tensor(FR.encode_many(domain_x), "cpu"), ch, inp


def program(prot, cols, part_vals, ch, inp):
    prog = q.compile_constraints(prot.constraints, cols, part_vals.shape[1])
    return prog, q.constants_table(prog, inp["y"], ch, "cpu")


@pytest.mark.parametrize("name", ["toy", "two_phase", "handmade", "keccak_table", "mpt"])
def test_plain_equals_tree_walk(rec, name):
    prot, cols, vals, dx, ch, inp = port_case(rec, name)
    got = q.h_part(prot, cols, vals, dx, ch, inp["y"])
    assert torch.equal(got, q.h_part_by_nodes(prot, cols, vals, dx, ch, inp["y"]))


@pytest.mark.parametrize("name", ["toy", "two_phase", "handmade", "mpt"])
def test_lanewise_and_sampled_rows_equal_whole(rec, name):
    """The lane loop run lane by lane, as kernel M runs it (every register
    reused inside the loop), and the plain version on a row sample with
    both wrap rows, equal the whole vectorised evaluation."""
    prot, cols, vals, dx, ch, inp = port_case(rec, name)
    prog, consts = program(prot, cols, vals, ch, inp)
    whole = q.plain_evaluate(prog, vals, dx, consts)
    assert torch.equal(q.plain_evaluate(prog, vals, dx, consts, lanewise=True), whole)
    rows = [15, 0, 7, 1, 14]
    assert torch.equal(q.plain_evaluate(prog, vals, dx, consts, rows=rows), whole[rows])


@pytest.mark.parametrize("name", LIVE)
def test_equals_reference_live(rec, name):
    prot, cols, vals, dx, ch, inp = port_case(rec, name)
    want = rec.reference_quotient(circuit(rec, name, "jax"), inp)
    assert FR.decode_many(q.h_part(prot, cols, vals, dx, ch, inp["y"])) == want


@pytest.mark.parametrize("name", ["keccak_table", "mpt"])
def test_equals_recorded_reference(rec, vectors, name):
    prot, cols, vals, dx, ch, inp = port_case(rec, name, vectors[name])
    assert FR.decode_many(q.h_part(prot, cols, vals, dx, ch, inp["y"])) == vectors[f"{name}_fold"]


def test_handmade_program(rec):
    """The compiler's output on the hand-made circuit: shared subtrees once,
    fused subtractions, rolled member lists, constants reduced, and every
    index inside its input."""
    prot, cols, vals, dx, ch, inp = port_case(rec, "handmade")
    prog, consts = program(prot, cols, vals, ch, inp)
    ops = prog.code[:, 0].tolist()
    # before the first lane loop: shared's product (once for its three
    # readers), q * (..), shared * r and DomainX * -3
    assert ops[:ops.index(q.OP_LANES)].count(q.OP_MUL) == 4
    assert ops.count(q.OP_LANES) == ops.count(q.OP_END_LANES) == 2
    # a - b, shared*r - c and q*lanes - lanes*shared fuse; lanes - a*shared
    # negates its scalar operand once, before the loop
    assert (ops.count(q.OP_SUB), ops.count(q.OP_NEG)) == (3, 1)
    assert ops.index(q.OP_NEG) < len(ops) - 1 - ops[::-1].index(q.OP_LANES)
    assert prog.consts == [5, FR_MOD - 3]  # FR_MOD + 5 and -3, reduced
    g = [c for c in cs_columns(prot) if c[0] == "g"][0]
    idx = {c: i for i, c in enumerate(cols)}
    gcols = [idx[col] for col in g[1]]
    rolled = {tuple(prog.members[a:a + 4].tolist()) for op, _, a, _ in prog.code.tolist() if op == q.OP_GROUP}
    assert tuple(gcols[(z - 1) % 4] for z in range(4)) in rolled  # roll 1 and roll 5
    assert tuple(gcols[(z - 2) % 4] for z in range(4)) in rolled
    assert len(prog.members) == 12  # g rolled by 1 (and 5), h by -1, g by 2
    q._check_program(prog, vals.shape[0], consts.shape[0])
    assert prog.n_regs <= 8
    assert f"{prog.n_regs} registers at peak" in prog.describe()


def cs_columns(prot):
    """(group name, columns) of the vector groups the protocol queries."""
    out, stack, seen = [], [e for e, _ in prot.constraints], set()
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        if isinstance(e, ex.GroupQuery) and e.group.name not in [o[0] for o in out]:
            out.append((e.group.name, e.group.columns))
        stack += list(q._children(e))
    return out


def test_check_program_rejects_indices_outside_inputs(rec):
    prot, cols, vals, dx, ch, inp = port_case(rec, "handmade")
    prog, consts = program(prot, cols, vals, ch, inp)
    col = int(np.flatnonzero(prog.code[:, 0] == q.OP_COL)[0])
    for i, field, value in ((col, 2, len(cols)), (col, 3, 16), (col, 1, prog.n_regs),
                            (len(prog.code) - 1, 0, q.OP_X)):
        code = prog.code.copy()
        code[i, field] = value
        with pytest.raises(ValueError):
            q._check_program(dataclasses.replace(prog, code=code), vals.shape[0], consts.shape[0])


def test_compile_rejects_unknown_column_and_width(rec):
    prot, cols, vals, dx, ch, inp = port_case(rec, "handmade")
    with pytest.raises(KeyError):
        q.compile_constraints(prot.constraints, cols[1:], 16)
    e, width = next(c for c in prot.constraints if c[1])
    with pytest.raises(ValueError):
        q.compile_constraints([(e, width + 1)], cols, 16)


def test_h_part_on_the_cpu_launches_no_kernel(rec):
    """The prover's _h_part takes the plain version for CPU tensors and
    gives the tree walk's words."""
    prot, cols, vals, dx, ch, inp = port_case(rec, "toy")
    before = kernels.launch_counts()
    got = prv._h_part(prot, cols, vals, dx, ch, inp["y"])
    assert kernels.launch_counts() == before
    assert torch.equal(got, q.h_part_by_nodes(prot, cols, vals, dx, ch, inp["y"]))


# ---------------------------------------------------------------------------
# hand-made programs: each instruction through the plain version (kernel
# M's exact counterpart) against Python integers, and the checker's bounds
# one at a time
# ---------------------------------------------------------------------------

N_ROWS = 4


def _prog(code, n_regs, members=()):
    return q.Program(code=np.asarray(code, np.int32), members=np.asarray(members, np.int32), consts=[],
                     n_challenges=0, n_regs=n_regs, n_rows=N_ROWS, muls=0, adds=0)


def _loads3():
    """Columns 0, 1, 2 at rotations 0, 1, 3 (stored as n - 1 in [0, n))
    into registers 0, 1, 2."""
    return [[q.OP_COL, 0, 0, 0], [q.OP_COL, 1, 1, 1], [q.OP_COL, 2, 2, 3]]


# name: (instructions after _loads3 leaving v in register 3, v from the
# three loaded values, the constant c and the domain point x)
OPCODE_CASES = {
    "add": ([[q.OP_ADD, 3, 0, 1]], lambda a, b, d, c, x: a + b),
    "sub": ([[q.OP_SUB, 3, 0, 1]], lambda a, b, d, c, x: a - b),
    "neg": ([[q.OP_NEG, 3, 2, 0]], lambda a, b, d, c, x: -d),
    "mul": ([[q.OP_MUL, 3, 0, 1]], lambda a, b, d, c, x: a * b),
    "square": ([[q.OP_MUL, 3, 2, 2]], lambda a, b, d, c, x: d * d),
    "const": ([[q.OP_CONST, 3, 1, 0], [q.OP_MUL, 3, 3, 0]], lambda a, b, d, c, x: c * a),
    "domain_x": ([[q.OP_X, 3, 0, 0], [q.OP_SUB, 3, 3, 1]], lambda a, b, d, c, x: x - b),
    "chain": ([[q.OP_SUB, 3, 0, 1], [q.OP_MUL, 3, 3, 2], [q.OP_ADD, 3, 3, 0], [q.OP_NEG, 1, 3, 0],
               [q.OP_MUL, 3, 1, 1]], lambda a, b, d, c, x: ((a - b) * d + a) ** 2),
}


def _fr(rng, count):
    return [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(count)]


@pytest.mark.parametrize("case", sorted(OPCODE_CASES))
def test_opcode_program(case):
    """One instruction (or a short chain) on three loaded columns, a
    constant and the domain point, then two folds (v, then column 2): the
    plain version, whole and lane by lane, against Python integers row by
    row, rotations wrapping at n - 1."""
    body, want = OPCODE_CASES[case]
    rng = np.random.default_rng(len(case))
    cols, xs, (y, c) = [_fr(rng, N_ROWS) for _ in range(3)], _fr(rng, N_ROWS), _fr(rng, 2)
    code = _loads3() + body + [[q.OP_FOLD, 0, 3, 0], [q.OP_COL, 2, 2, 3], [q.OP_FOLD, 0, 2, 0],
                               [q.OP_END, 0, 0, 0]]
    prog = _prog(code, 4)
    consts = ff.to_tensor(FR.encode_many([y, c]), "cpu")
    q._check_program(prog, 3, 2)
    vals = ff.to_tensor(np.stack([FR.encode_many(col) for col in cols]), "cpu")
    dx = ff.to_tensor(FR.encode_many(xs), "cpu")
    for lanewise in (False, True):
        got = FR.decode_many(q.plain_evaluate(prog, vals, dx, consts, lanewise=lanewise))
        for r in range(N_ROWS):
            a, b, d = cols[0][r], cols[1][(r + 1) % N_ROWS], cols[2][(r + 3) % N_ROWS]
            v = want(a, b, d, c, xs[r]) % FR_MOD
            assert got[r] == (v * y + d) % FR_MOD, (lanewise, r)


def test_lane_loop_program():
    """A lane loop of width 3 over a rolled member list (columns 2, 0, 1 at
    rotation 1), each lane times column 0 and folded in turn: the plain
    version, whole and lane by lane, against Python integers."""
    rng = np.random.default_rng(3)
    cols, (y,) = [_fr(rng, N_ROWS) for _ in range(3)], _fr(rng, 1)
    code = [[q.OP_COL, 0, 0, 0], [q.OP_LANES, 0, 3, 0], [q.OP_GROUP, 1, 0, 1], [q.OP_MUL, 1, 1, 0],
            [q.OP_FOLD, 0, 1, 0], [q.OP_END_LANES, 0, 0, 0], [q.OP_END, 0, 0, 0]]
    prog = _prog(code, 2, members=[2, 0, 1])
    consts = ff.to_tensor(FR.encode_many([y]), "cpu")
    q._check_program(prog, 3, 1)
    vals = ff.to_tensor(np.stack([FR.encode_many(col) for col in cols]), "cpu")
    dx = ff.to_tensor(FR.encode_many(_fr(rng, N_ROWS)), "cpu")
    for lanewise in (False, True):
        got = FR.decode_many(q.plain_evaluate(prog, vals, dx, consts, lanewise=lanewise))
        for r in range(N_ROWS):
            h = 0
            for member in (2, 0, 1):
                h = (h * y + cols[member][(r + 1) % N_ROWS] * cols[0][r]) % FR_MOD
            assert got[r] == h, (lanewise, r)


# name: (instruction index, word, value) written into the lane-loop program
# above (3 columns, 2 registers, 1 constants row, 3 members)
BAD_INDEX_CASES = {
    "column": (0, 2, 3),
    "rotation": (0, 3, N_ROWS),
    "dst": (0, 1, 2),
    "dst_negative": (3, 1, -1),
    "operand_a": (3, 2, 2),
    "operand_b": (3, 3, 2),
    "fold_operand": (4, 2, 2),
    "lane_width": (1, 2, 0),
    "group_members": (2, 2, 1),
    "group_rotation": (2, 3, -1),
    "opcode": (5, 0, q.OP_END + 1),
    "no_end": (6, 0, q.OP_X),
}


@pytest.mark.parametrize("case", sorted(BAD_INDEX_CASES) + ["const_row", "member_column"])
def test_check_program_rejects_each_bad_index(case):
    """The checker refuses each index that would take kernel M outside its
    inputs (it checks none itself), one at a time, on a program it accepts."""
    code = [[q.OP_COL, 0, 0, 0], [q.OP_LANES, 0, 3, 0], [q.OP_GROUP, 1, 0, 1], [q.OP_MUL, 1, 1, 0],
            [q.OP_FOLD, 0, 1, 0], [q.OP_END_LANES, 0, 0, 0], [q.OP_END, 0, 0, 0]]
    members = [2, 0, 1]
    q._check_program(_prog(code, 2, members), 3, 1)
    if case == "const_row":
        code[3:3] = [[q.OP_CONST, 1, 1, 0]]
    elif case == "member_column":
        members[1] = 3
    else:
        i, word, value = BAD_INDEX_CASES[case]
        code[i][word] = value
    with pytest.raises(ValueError):
        q._check_program(_prog(code, 2, members), 3, 1)
