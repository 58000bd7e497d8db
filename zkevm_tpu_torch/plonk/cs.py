"""ConstraintSystem: columns, gates, lookups, permutation, phases (a copy of
zkevm_tpu/plonk/cs.py; the port keeps its own host-side classes).

Analog of halo2_proofs' `ConstraintSystem<F>` + `plonk::circuit` column
types (reference: scroll-tech/halo2 v1.1 via Cargo.toml:40;
the zkEVM configures ~hundreds of columns through this interface in e.g.
zkevm-circuits/src/super_circuit.rs:472-515 `SuperCircuit::configure`).

Differences from halo2, by design (TPU-first):
- selectors are plain fixed columns (no selector compression pass);
- assignment is array-based: a circuit fills (n,)-shaped numpy arrays per
  column instead of cell-by-cell region assignment (the vectorized idiom
  that replaces `parallel_syn` region parallelism, SURVEY.md §2.5);
- equality constraints are recorded as (col, row) <-> (col, row) pairs and
  compiled to sigma cycles at keygen, same math as halo2's permutation
  argument.
"""

from __future__ import annotations

from dataclasses import dataclass

from zkevm_tpu_torch.plonk.expr import ChallengeExpr, Expr, GroupQuery, Query


@dataclass(frozen=True)
class Column:
    kind: str  # "fixed" | "advice" | "instance"
    index: int
    phase: int = 0  # advice only; fixed/instance are phase 0

    def cur(self) -> Query:
        return Query(self, 0)

    def rot(self, r: int) -> Query:
        return Query(self, r)

    def prev(self) -> Query:
        return Query(self, -1)

    def next(self) -> Query:
        return Query(self, 1)

    def __repr__(self):
        return f"{self.kind}{self.index}"


@dataclass(frozen=True)
class ColumnGroup:
    """A 'vector column': W scalar columns addressed as one SIMD lane axis
    (see GroupQuery). Committed/opened as W ordinary columns."""

    name: str
    columns: tuple

    @property
    def width(self) -> int:
        return len(self.columns)

    def q(self, rotation: int = 0, roll: int = 0) -> GroupQuery:
        return GroupQuery(self, rotation, roll)


@dataclass(frozen=True)
class Challenge:
    index: int
    phase: int

    def expr(self) -> ChallengeExpr:
        return ChallengeExpr(self.index, self.phase)


@dataclass
class Gate:
    name: str
    polys: list  # list[Expr]
    vector_width: int = 0  # 0 = scalar gate; W = each poly is W lanes


@dataclass
class Lookup:
    name: str
    inputs: list  # list[Expr]
    tables: list  # list[Expr]


class ConstraintSystem:
    def __init__(self):
        self.fixed_columns: list[Column] = []
        self.advice_columns: list[Column] = []
        self.instance_columns: list[Column] = []
        self.challenges: list[Challenge] = []
        self.gates: list[Gate] = []
        self.lookups: list[Lookup] = []
        self.permutation_columns: list[Column] = []  # columns usable in copies
        self.copies: list[tuple[Column, int, Column, int]] = []

    # -- allocation -----------------------------------------------------
    def fixed_column(self) -> Column:
        c = Column("fixed", len(self.fixed_columns))
        self.fixed_columns.append(c)
        return c

    def advice_column(self, phase: int = 0) -> Column:
        c = Column("advice", len(self.advice_columns), phase)
        self.advice_columns.append(c)
        return c

    def instance_column(self) -> Column:
        c = Column("instance", len(self.instance_columns))
        self.instance_columns.append(c)
        return c

    def challenge_usable_after(self, phase: int) -> Challenge:
        ch = Challenge(len(self.challenges), phase + 1)
        self.challenges.append(ch)
        return ch

    def selector(self) -> Column:
        """halo2 Selector — here just a fixed 0/1 column."""
        return self.fixed_column()

    def advice_group(self, name: str, width: int, phase: int = 0) -> ColumnGroup:
        return ColumnGroup(name, tuple(self.advice_column(phase) for _ in range(width)))

    def fixed_group(self, name: str, width: int) -> ColumnGroup:
        return ColumnGroup(name, tuple(self.fixed_column() for _ in range(width)))

    # -- constraints ----------------------------------------------------
    def create_gate(self, name: str, polys) -> None:
        if isinstance(polys, Expr):
            polys = [polys]
        self.gates.append(Gate(name, list(polys)))

    def create_vector_gate(self, name: str, polys, width: int) -> None:
        """Each poly is a W-lane vector constraint (uses GroupQuery)."""
        if isinstance(polys, Expr):
            polys = [polys]
        self.gates.append(Gate(name, list(polys), vector_width=width))

    def lookup(self, name: str, pairs) -> None:
        """pairs: list of (input_expr, table_expr)."""
        inputs = [p[0] for p in pairs]
        tables = [p[1] for p in pairs]
        self.lookups.append(Lookup(name, inputs, tables))

    def enable_equality(self, column: Column) -> None:
        if column not in self.permutation_columns:
            self.permutation_columns.append(column)

    def copy(self, col_a: Column, row_a: int, col_b: Column, row_b: int) -> None:
        """Equality constraint between two cells (layouter `assign_advice_from_*`
        / `constrain_equal` analog)."""
        self.enable_equality(col_a)
        self.enable_equality(col_b)
        self.copies.append((col_a, row_a, col_b, row_b))

    # -- derived quantities ---------------------------------------------
    @property
    def num_phases(self) -> int:
        phases = {0}
        phases.update(c.phase for c in self.advice_columns)
        phases.update(ch.phase for ch in self.challenges)
        return max(phases) + 1

    def permutation_chunk_len(self) -> int:
        return max(self.gate_degree() - 2, 1)

    def gate_degree(self) -> int:
        """Max degree over gates, lookup constraint sets, permutation sets.

        Lookup z-transition has degree 2 + max(deg(inputs), deg(tables));
        permutation transition has degree 2 + chunk_len (chunk_len chosen
        from gate degree, halo2-style fixpoint: chunk = deg - 2).
        """
        d = 3  # floor: permutation/lookup arguments need degree >= 3
        for g in self.gates:
            for p in g.polys:
                d = max(d, p.degree())
        for lk in self.lookups:
            din = max((e.degree() for e in lk.inputs), default=1)
            dta = max((e.degree() for e in lk.tables), default=1)
            # activity gating (1 - l_last - l_blind) adds 1; z-transition
            # multiplies input and table compressions
            d = max(d, 2 + din + dta)
        if self.permutation_columns:
            chunk = max(d - 2, 1)
            d = max(d, 2 + chunk)
        return d

    def blinding_factors(self) -> int:
        """Rows reserved at the tail for zero-knowledge blinding.

        halo2: #phases-dependent; we reserve enough for: each advice poly's
        random tail rows, the permutation argument (chunk_len rows), and
        lookup z rotations. Matches halo2's formula floor of 5-ish for
        typical systems.
        """
        return max(3, self.permutation_chunk_len() + 2) + 1

    def usable_rows(self, n: int) -> int:
        return n - (self.blinding_factors() + 1)
