"""Multi-permutation Poseidon circuit exposing the PoseidonTable.

Port of ``zkevm_tpu/circuits/poseidon_table.py``: the same columns, round
gates (one row per round, degree-6 full and partial gates) and lookup
surfaces. The last row of every 65-row permutation slot is a lookup
surface:

    (in0, in1, cap, out) = (state_i at row -64 ..., state_0 here)

Every slot carries a real permutation trace (unused slots run the zero
state), so each table row is a genuine Poseidon evaluation.

``assign`` differs from the reference in how, not what, it fills: the
three state columns come from kernel E's trace of every slot in one launch
(``hash.poseidon.permute_trace``), and the fixed columns (round constants
and selectors) repeat one 65-row pattern, tiled on the device; the
reference computes every round of every slot in Python and writes the
cells one at a time.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from zkevm_tpu_torch.device import resolve_device
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.hash import poseidon as pos
from zkevm_tpu_torch.plonk.assign import Assignment
from zkevm_tpu_torch.plonk.cs import Column, ConstraintSystem
from zkevm_tpu_torch.plonk.expr import Const, Expr

SPEC = pos.P128_POW5_T3
T = SPEC.t
ROUNDS = SPEC.r_f + SPEC.r_p  # 64
PERM = ROUNDS + 1  # 65 rows per slot


@dataclass
class PoseidonTable:
    """(in0, in1, cap, out) rows — one per permutation slot."""

    exprs: list

    def lookup(self, cs: ConstraintSystem, name: str, q: Expr,
               in0: Expr, in1: Expr, cap: Expr, out: Expr) -> None:
        """`poseidon([in0, in1, cap])[0] == out`, gated by boolean q."""
        ins = [q * in0, q * in1, q * cap, q * out]
        # enabled column: q itself against the fixed table selector
        cs.lookup(name, [(q, self.exprs[0])] + list(zip(ins, self.exprs[1:])))


@dataclass
class PoseidonPermTable:
    """Full-state permutation surface: (s0,s1,s2) -> (s0',s1',s2'), the
    chained-sponge interface the in-circuit Poseidon transcript needs."""

    exprs: list

    def lookup(self, cs: ConstraintSystem, name: str, q: Expr,
               s_in: list, s_out: list) -> None:
        """`permute([s_in]) == s_out` (element-wise), gated by boolean q."""
        ins = [q * e for e in list(s_in) + list(s_out)]
        cs.lookup(name, [(q, self.exprs[0])] + list(zip(ins, self.exprs[1:])))


@dataclass
class PoseidonTableConfig:
    state: list
    rc: list
    q_full: Column
    q_partial: Column
    q_tbl: Column
    table: PoseidonTable
    perm_table: "PoseidonPermTable" = None


def configure(cs: ConstraintSystem) -> PoseidonTableConfig:
    state = [cs.advice_column() for _ in range(T)]
    rc = [cs.fixed_column() for _ in range(T)]
    q_full = cs.fixed_column()
    q_partial = cs.fixed_column()
    q_tbl = cs.fixed_column()
    _, mds = pos.generate_constants(SPEC)

    def mixed(sboxed):
        return [
            sum((Const(mds[j][i]) * sboxed[i] for i in range(T)), Const(0))
            for j in range(T)
        ]

    def pow5(e):
        e2 = e * e
        return e2 * e2 * e

    full_in = [pow5(state[i].cur() + rc[i].cur()) for i in range(T)]
    full_out = mixed(full_in)
    cs.create_gate(
        "pt_full",
        [q_full.cur() * (full_out[j] - state[j].next()) for j in range(T)],
    )
    part_in = [pow5(state[0].cur() + rc[0].cur())] + [
        state[i].cur() + rc[i].cur() for i in range(1, T)
    ]
    part_out = mixed(part_in)
    cs.create_gate(
        "pt_partial",
        [q_partial.cur() * (part_out[j] - state[j].next()) for j in range(T)],
    )

    qt = q_tbl.cur()
    table = PoseidonTable([
        qt,
        qt * state[0].rot(-ROUNDS),
        qt * state[1].rot(-ROUNDS),
        qt * state[2].rot(-ROUNDS),
        qt * state[0].cur(),
    ])
    perm_table = PoseidonPermTable([
        qt,
        qt * state[0].rot(-ROUNDS),
        qt * state[1].rot(-ROUNDS),
        qt * state[2].rot(-ROUNDS),
        qt * state[0].cur(),
        qt * state[1].cur(),
        qt * state[2].cur(),
    ])
    return PoseidonTableConfig(state, rc, q_full, q_partial, q_tbl, table,
                               perm_table)


def capacity(cs: ConstraintSystem, n: int) -> int:
    return (cs.usable_rows(n) - 1) // PERM


def h2(tag: int, a: int, b: int) -> int:
    """Host golden (zktrie._h2)."""
    return pos.permute_golden(
        SPEC, [a % FR_MOD, b % FR_MOD, ((1 << 64) * tag) % FR_MOD]
    )[0]


def _slot_pattern(cfg: PoseidonTableConfig) -> dict:
    """The fixed columns of one 65-row slot: {column: (65, 8) words}."""
    rc, _ = pos.generate_constants(SPEC)
    half = SPEC.r_f // 2
    one = FR.encode(1)
    pat = {c: np.zeros((PERM, ff.W), np.uint32)
           for c in [*cfg.rc, cfg.q_full, cfg.q_partial, cfg.q_tbl]}
    pat[cfg.q_tbl][ROUNDS] = one
    for r in range(ROUNDS):
        is_full = r < half or r >= half + SPEC.r_p
        pat[cfg.q_full if is_full else cfg.q_partial][r] = one
    for i in range(T):
        pat[cfg.rc[i]][:ROUNDS] = FR.encode_many([rc[r][i] for r in range(ROUNDS)])
    return pat


def assign(
    cs: ConstraintSystem,
    cfg: PoseidonTableConfig,
    n: int,
    states: list,
    asg: Assignment | None = None,
    *,
    device=None,
) -> Assignment:
    """states: list of [in0, in1, cap] initial states; unused slots run
    the zero permutation. The trace runs on ``device`` (CUDA unless the
    caller asks for the CPU)."""
    dev = resolve_device(device)
    asg = asg if asg is not None else Assignment(cs, n)
    cap_slots = capacity(cs, n)
    if len(states) > cap_slots:
        raise ValueError(f"{len(states)} perms > {cap_slots}")
    rows = cap_slots * PERM
    init = np.zeros((cap_slots * T, ff.W), np.uint32)
    if states:
        init[: len(states) * T] = FR.encode_many([v for s in states for v in s])
    trace = pos.permute_trace(SPEC, ff.to_tensor(init.reshape(cap_slots, T, ff.W), dev))
    for i in range(T):
        asg.cols[cfg.state[i]][:rows] = ff.to_words(trace[i].reshape(rows, ff.W))
    del trace
    for col, pat in _slot_pattern(cfg).items():
        tiled = ff.to_tensor(pat, dev).repeat(cap_slots, 1)
        asg.cols[col][:rows] = ff.to_words(tiled)
    return asg
