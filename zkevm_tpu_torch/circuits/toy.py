"""Small test circuits shared by the port's tests, the smoke run and the
reference-vector script.

``build_toy`` / ``assign_toy`` is the K=5 circuit of ``tests/test_plonk.py``
(a mul-add gate, a 4-bit range lookup and a copy constraint);
``build_two_phase`` / ``two_phase_witness`` adds a phase-1 running RLC
under one challenge. Both are written against the ConstraintSystem and
Assignment API that the port shares with the reference, so passing a
package's classes builds the same circuit in that package.
"""

from __future__ import annotations

from zkevm_tpu_torch.ff.goldens import FR_MOD

K = 5
N = 1 << K
TOY_A = [3, 5, 1, 15, 0, 7, 9, 3]
TOY_B = [2, 4, 6, 1, 0, 3, 2, 2]
TWO_PHASE_VALUES = [5, 17, 3, 250, 0, 1, 99, 42]


def build_toy(ConstraintSystem):
    cs = ConstraintSystem()
    q = cs.fixed_column()  # gate selector
    table = cs.fixed_column()  # 4-bit range table
    qt = cs.fixed_column()  # lookup selector
    a = cs.advice_column()
    b = cs.advice_column()
    c = cs.advice_column()
    cs.create_gate("mul_add", q.cur() * (a.cur() * b.cur() + 7 - c.cur()))
    cs.lookup("a_in_4bits", [(qt.cur() * a.cur(), table.cur())])
    cs.copy(c, 0, c, 7)  # c[0] == c[7] (13 == 13)
    return cs, (q, table, qt, a, b, c)


def assign_toy(cs, cols, Assignment, n=N, break_lookup=False):
    q, table, qt, a, b, c = cols
    asg = Assignment(cs, n)
    avals = list(TOY_A)
    if break_lookup:
        avals[3] = 77  # not 4-bit
    cvals = [x * y + 7 for x, y in zip(avals, TOY_B)]
    asg.set_ints(q, 0, [1] * len(avals))
    asg.set_ints(qt, 0, [1] * len(avals))
    asg.set_ints(table, 0, list(range(16)))
    asg.set_ints(a, 0, avals)
    asg.set_ints(b, 0, TOY_B)
    asg.set_ints(c, 0, cvals)
    return asg


def fixed_only(cs, asg, Assignment):
    out = Assignment(cs, asg.n)
    for col in cs.fixed_columns:
        out.cols[col][:] = asg.cols[col]
    return out


def build_two_phase(ConstraintSystem):
    cs = ConstraintSystem()
    q0 = cs.fixed_column()  # row 0
    q = cs.fixed_column()  # rows 1.. of the message
    a = cs.advice_column()  # phase-0 bytes
    r = cs.challenge_usable_after(0)
    acc = cs.advice_column(phase=1)  # running RLC under r
    cs.create_gate("rlc_first", q0.cur() * (acc.cur() - a.cur()))
    cs.create_gate("rlc_step", q.cur() * (acc.cur() - (acc.prev() * r.expr() + a.cur())))
    return cs, (q0, q, a, acc, r)


def two_phase_witness(cs, cols, Assignment, n=N):
    """-> (fixed-only Assignment, create_proof witness callback)."""
    q0, q, a, acc, r = cols
    asg = Assignment(cs, n)
    vals = TWO_PHASE_VALUES
    asg.set_ints(q0, 0, [1])
    asg.set_ints(q, 1, [1] * (len(vals) - 1))
    asg.set_ints(a, 0, vals)

    def witness(phase, challenges):
        if phase == 0:
            return {a: asg.cols[a]}
        rv = challenges[r]
        run, accs = 0, []
        for v in vals:
            run = (run * rv + v) % FR_MOD
            accs.append(run)
        asg.set_ints(acc, 0, accs)
        return {acc: asg.cols[acc]}

    return fixed_only(cs, asg, Assignment), witness

