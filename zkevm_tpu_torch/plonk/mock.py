"""MockProver: evaluate every constraint on the device, report failures.

Port of ``zkevm_tpu/plonk/mock.py`` (the role of halo2's
``MockProver::run`` / ``assert_satisfied``). The failure lists are the
reference's, entry for entry: kind, name, index and rows.

- Gates: each polynomial is evaluated over the base domain by the port's
  expression evaluator (field kernel A, one launch per tree node). Where
  the polynomial starts with fixed-column selectors (``_peel_selectors``)
  only the rows on which every selector is non-zero are evaluated
  (``EvalContext.set_rows``, padded to a power of two with the first
  row). The per-row zero test runs on the device (``ff.nonzero``, kernel
  F), so one flag per row (per row and lane for vector gates) comes back
  to the host.
- Lookups and copies are checked on the host, as in the reference, over
  the active rows 0 .. usable - 2. Lookup membership gives every distinct
  row tuple a dense id (``_row_key_ids``); the reference takes them from
  ``np.unique(axis=0)``, which takes ~50 s for one lookup of 2^20
  five-element rows, the port from ``dense_ranks`` (a lexsort over 64-bit
  word pairs, ~3 s), which gives equal rows equal ids as well.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from zkevm_tpu_torch.device import resolve_device
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.plonk.assign import Assignment
from zkevm_tpu_torch.plonk.cs import ConstraintSystem
from zkevm_tpu_torch.plonk.expr import EvalContext, Prod, Query
from zkevm_tpu_torch.plonk.prover import dense_ranks


def _peel_selectors(poly):
    """Split `q1 * q2 * ... * rest` into ([fixed-column selector queries],
    rest): the leading left-spine factors that are plain fixed-column
    queries. Sound row restriction: wherever any selector evaluates to 0
    the whole product is 0, so `rest` only needs checking on rows where
    every selector is nonzero."""
    spine = []
    node = poly
    while isinstance(node, Prod):
        spine.append(node.b)
        node = node.a
    spine.append(node)
    spine.reverse()
    sels = []
    i = 0
    while (
        i < len(spine)
        and isinstance(spine[i], Query)
        and spine[i].column.kind == "fixed"
    ):
        sels.append(spine[i])
        i += 1
    if not sels or i == len(spine):
        return [], poly
    rest = spine[i]
    for f in spine[i + 1 :]:
        rest = Prod(rest, f)
    return sels, rest


def _row_key_ids(tables: list, inputs: list, active: int):
    """Dense ids for (active,)-row tuples of word arrays, shared between
    table and input sides (vectorized multiset membership)."""
    tab = np.concatenate([np.asarray(t)[:active] for t in tables], axis=1)
    inp = np.concatenate([np.asarray(i)[:active] for i in inputs], axis=1)
    ids = dense_ranks(np.concatenate([tab, inp]))
    return ids[:active], ids[active:]


@dataclass
class Failure:
    kind: str  # "gate" | "lookup" | "copy"
    name: str
    index: int
    rows: list

    def __repr__(self):
        rows = self.rows[:8]
        more = "..." if len(self.rows) > 8 else ""
        return f"[{self.kind}] {self.name}#{self.index} rows={rows}{more}"


class MockProver:
    @staticmethod
    def default_challenges(cs: ConstraintSystem) -> list[int]:
        """The deterministic pseudo-challenges (halo2 mock convention) —
        exported so circuits can pre-fill challenge-dependent phase-1
        columns before assert_satisfied."""
        return [0x100 + 7 * i for i in range(len(cs.challenges))]

    def __init__(self, cs: ConstraintSystem, assignment: Assignment,
                 challenges: list[int] | None = None, *, device=None):
        """Gates evaluate on ``device`` (CUDA unless the caller asks for
        the CPU)."""
        self.cs = cs
        self.assignment = assignment
        self.n = assignment.n
        self.device = resolve_device(device)
        if challenges is None:
            # deterministic pseudo-challenges, like halo2's mock challenge
            # values — fine because the mock prover checks identities that
            # must hold for every challenge
            challenges = self.default_challenges(cs)
        self.challenge_values = challenges

    def verify(self) -> list[Failure]:
        cs, n, dev = self.cs, self.n, self.device
        # Real-prover semantics: gates are enforced on EVERY row (circuits
        # must selector-gate them); lookups/permutations only on the active
        # region rows 0..usable-2 (the grand-product transition rows).
        active = cs.usable_rows(n) - 1
        cols = {c: ff.to_tensor(a, dev) for c, a in self.assignment.cols.items()}
        ch = [FR.const(v, dev) for v in self.challenge_values]
        ctx = EvalContext(cols, ch, dev)
        failures: list[Failure] = []

        # host views of fixed columns for the selector-peeled fast path
        fixed_nonzero: dict = {}

        def sel_rows(sels) -> np.ndarray:
            mask = None
            for sq in sels:
                col = sq.column
                if col not in fixed_nonzero:
                    fixed_nonzero[col] = np.any(self.assignment.cols[col] != 0, axis=1)
                m = fixed_nonzero[col]
                if sq.rotation:
                    m = np.roll(m, -sq.rotation)
                mask = m if mask is None else (mask & m)
            return np.nonzero(mask)[0]

        for gate in cs.gates:
            for pi, poly in enumerate(gate.polys):
                sels, rest = _peel_selectors(poly)
                rows_map = None
                if sels:
                    rows = sel_rows(sels)
                    if rows.size == 0:
                        continue  # every row zeroed by a selector
                    # pad to a power of two, as the reference buckets shapes
                    m = 1
                    while m < rows.size:
                        m *= 2
                    rows_map = np.concatenate(
                        [rows, np.full(m - rows.size, rows[0], np.int64)]
                    )
                    ctx.set_rows(rows_map)
                    vals = rest.evaluate(ctx)
                    ctx.set_rows(None)
                else:
                    vals = poly.evaluate(ctx)
                nz = np.atleast_1d(ff.nonzero(vals).cpu().numpy())
                del vals
                if gate.vector_width:
                    bad_rows = np.nonzero(nz.any(axis=1))[0]
                    if bad_rows.size:
                        lanes = np.nonzero(nz[bad_rows[0]])[0]
                        if rows_map is not None:
                            bad_rows = np.unique(rows_map[bad_rows])
                        failures.append(
                            Failure(
                                "gate",
                                f"{gate.name}[lanes {lanes.tolist()[:8]}]",
                                pi,
                                bad_rows.tolist(),
                            )
                        )
                else:
                    bad = np.nonzero(nz)[0]
                    if bad.size:
                        if rows_map is not None:
                            bad = np.unique(rows_map[bad])
                        failures.append(Failure("gate", gate.name, pi, bad.tolist()))

        def eval_rows(e):
            # constants evaluate to a single (8,) word vector — broadcast to
            # per-row shape like the real prover's compress_vals does
            return ff.to_words(e.evaluate(ctx).expand(n, ff.W))

        for li, lk in enumerate(cs.lookups):
            inputs = [eval_rows(e) for e in lk.inputs]
            tables = [eval_rows(e) for e in lk.tables]
            tab_ids, inp_ids = _row_key_ids(tables, inputs, active)
            ok = np.isin(inp_ids, tab_ids)
            bad_rows = np.nonzero(~ok)[0]
            if bad_rows.size:
                failures.append(Failure("lookup", lk.name, li, bad_rows.tolist()))

        for ci, (ca, ra, cb, rb) in enumerate(cs.copies):
            a = self.assignment.cols[ca][ra]
            b = self.assignment.cols[cb][rb]
            if not np.array_equal(a, b):
                failures.append(Failure("copy", f"{ca}@{ra}=={cb}@{rb}", ci, [ra, rb]))

        return failures

    def assert_satisfied(self) -> None:
        failures = self.verify()
        if failures:
            msgs = "\n".join(map(repr, failures[:20]))
            raise AssertionError(f"{len(failures)} constraint failures:\n{msgs}")
