"""Expression trees for PLONKish gates (halo2 ``Expression<F>`` analog).

Port of ``zkevm_tpu/plonk/expr.py``: the same tree classes, evaluated over
whole column tensors at once. ``evaluate(ctx)`` returns a ``(..., n, 8)``
Montgomery tensor computed with the field kernels, one launch per tree
node; rotations are row rolls and vector groups lane rolls.
``HostEvalContext`` / ``host_evaluate`` give the verifier's view over
claimed scalar evaluations.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR


class Expr:
    """Base class; operator overloads build trees from Python syntax."""

    def __add__(self, other):
        return Sum(self, _wrap(other))

    def __radd__(self, other):
        return Sum(_wrap(other), self)

    def __sub__(self, other):
        return Sum(self, Neg(_wrap(other)))

    def __rsub__(self, other):
        return Sum(_wrap(other), Neg(self))

    def __mul__(self, other):
        return Prod(self, _wrap(other))

    def __rmul__(self, other):
        return Prod(_wrap(other), self)

    def __neg__(self):
        return Neg(self)

    # -- analysis -------------------------------------------------------
    def degree(self) -> int:
        raise NotImplementedError

    def queries(self) -> set:
        """Set of (column, rotation) pairs referenced."""
        out = set()
        self._collect(out)
        return out

    def _collect(self, out: set) -> None:
        pass

    def evaluate(self, ctx: "EvalContext"):
        raise NotImplementedError


def _wrap(v) -> Expr:
    if isinstance(v, Expr):
        return v
    if isinstance(v, int):
        return Const(v)
    raise TypeError(f"cannot use {type(v)} in an expression")


@dataclass(frozen=True)
class Const(Expr):
    value: int

    def degree(self):
        return 0

    def evaluate(self, ctx):
        return ctx.constant(self.value % FR.modulus)


@dataclass(frozen=True)
class Query(Expr):
    """A (column, rotation) cell query. column is a Column object from cs."""

    column: Any
    rotation: int = 0

    def degree(self):
        return 1

    def _collect(self, out):
        out.add((self.column, self.rotation))

    def evaluate(self, ctx):
        return ctx.query(self.column, self.rotation)


@dataclass(frozen=True)
class ChallengeExpr(Expr):
    index: int  # global challenge index
    phase: int

    def degree(self):
        return 0

    def evaluate(self, ctx):
        return ctx.challenge(self.index)


@dataclass(frozen=True)
class GroupQuery(Expr):
    """Query of a ColumnGroup (a 'vector column' of W scalar columns) with a
    row rotation and a cyclic LANE roll: lane z reads member column
    (z - roll) mod W. This is the TPU-native circuit idiom — e.g. the 64
    bit-positions of a keccak lane are one group, and keccak's rho step is
    a roll instead of 1600 copy constraints. No reference-counterpart:
    halo2 has only scalar columns."""

    group: Any  # ColumnGroup (defined in cs.py; kept Any to avoid cycle)
    rotation: int = 0
    roll: int = 0

    def degree(self):
        return 1

    def _collect(self, out):
        for col in self.group.columns:
            out.add((col, self.rotation))

    def evaluate(self, ctx):
        return ctx.group_query(self.group, self.rotation, self.roll)


@dataclass(frozen=True)
class DomainX(Expr):
    """The identity polynomial X (used by the permutation argument's
    delta^j * X terms). Evaluates to the domain-point array on device
    contexts and to the challenge point on host contexts."""

    def degree(self):
        return 1

    def evaluate(self, ctx):
        return ctx.domain_x()


@dataclass(frozen=True)
class Neg(Expr):
    inner: Expr

    def degree(self):
        return self.inner.degree()

    def _collect(self, out):
        self.inner._collect(out)

    def evaluate(self, ctx):
        return ff.neg(FR, self.inner.evaluate(ctx))


def _align(a, b):
    """Insert a lane axis when a scalar-column value (rows, 16) meets a
    vector-group value (rows, W, 16) in one expression."""
    if hasattr(a, "ndim") and hasattr(b, "ndim") and a.ndim >= 2 and b.ndim >= 2:
        if a.ndim + 1 == b.ndim:
            a = a[..., None, :]
        elif b.ndim + 1 == a.ndim:
            b = b[..., None, :]
    return a, b


@dataclass(frozen=True)
class Sum(Expr):
    a: Expr
    b: Expr

    def degree(self):
        return max(self.a.degree(), self.b.degree())

    def _collect(self, out):
        self.a._collect(out)
        self.b._collect(out)

    def evaluate(self, ctx):
        va, vb = _align(self.a.evaluate(ctx), self.b.evaluate(ctx))
        return ff.add(FR, va, vb)


@dataclass(frozen=True)
class Prod(Expr):
    a: Expr
    b: Expr

    def degree(self):
        return self.a.degree() + self.b.degree()

    def _collect(self, out):
        self.a._collect(out)
        self.b._collect(out)

    def evaluate(self, ctx):
        va, vb = _align(self.a.evaluate(ctx), self.b.evaluate(ctx))
        return ff.mont_mul(FR, va, vb)


class EvalContext:
    """Maps queries to device tensors.

    columns: dict column -> (n, 8) Montgomery tensor (base domain or one
    part of the extended coset); rot_scale: row shift per unit rotation;
    challenges: list of (8,) Montgomery tensors. ``set_rows`` restricts
    evaluation to given rows (the MockProver's selector-peeled path).
    """

    def __init__(self, columns: dict, challenges, device, rot_scale: int = 1):
        self.columns = columns
        self.challenges = challenges
        self.device = torch.device(device)
        self.rot_scale = rot_scale
        first = next(iter(columns.values())) if columns else None
        self.n = first.shape[0] if first is not None else 1
        self.rows = None
        self._group_cache: dict = {}

    def constant(self, v: int):
        return FR.const(v, self.device)

    def challenge(self, index: int):
        return self.challenges[index]

    def set_rows(self, rows) -> None:
        """Restrict evaluation to the given row indices: queries gather rows
        (rows + rot) mod n instead of rolling whole columns. ``rows = None``
        lifts the restriction."""
        self.rows = None if rows is None else torch.as_tensor(rows, dtype=torch.int64).to(self.device)

    def _rows_at(self, rotation: int) -> torch.Tensor:
        return (self.rows + rotation * self.rot_scale) % self.n

    def query(self, column, rotation: int):
        arr = self.columns[column]
        if self.rows is not None:
            return arr.index_select(0, self._rows_at(rotation))
        if rotation == 0:
            return arr
        return torch.roll(arr, -rotation * self.rot_scale, dims=0)

    def set_domain_x(self, arr) -> None:
        self._domain_x = arr

    def domain_x(self):
        return self._domain_x

    def group_query(self, group, rotation: int, roll: int):
        """-> (n, W, 8) tensor (rows restricted: (m, W, 8)): member columns
        stacked on dim 1, rolled."""
        if group not in self._group_cache:
            self._group_cache[group] = torch.stack([self.columns[c] for c in group.columns], dim=1)
        arr = self._group_cache[group]
        if self.rows is not None:
            arr = arr.index_select(0, self._rows_at(rotation))
        elif rotation:
            arr = torch.roll(arr, -rotation * self.rot_scale, dims=0)
        if roll:
            arr = torch.roll(arr, roll, dims=1)
        return arr


class HostEvalContext:
    """Evaluates the same expression trees over claimed scalar evals
    (python ints) — the verifier's view. `evals` maps (column, rotation)
    -> int; challenges are ints; x is the evaluation point. For vector
    (group) constraints, set `lane` to pick the lane being evaluated."""

    def __init__(self, evals: dict, challenges: list[int], x: int, lane: int = 0):
        self.evals = evals
        self.challenges_int = challenges
        self.x = x
        self.lane = lane

    def constant(self, v: int):
        return v % FR.modulus

    def challenge(self, index: int):
        return self.challenges_int[index] % FR.modulus

    def query(self, column, rotation: int):
        return self.evals[(column, rotation)] % FR.modulus

    def group_query(self, group, rotation: int, roll: int):
        w = len(group.columns)
        col = group.columns[(self.lane - roll) % w]
        return self.evals[(col, rotation)] % FR.modulus

    def domain_x(self):
        return self.x % FR.modulus


def host_evaluate(expr: Expr, ctx: HostEvalContext) -> int:
    """Evaluate an expression tree to a python int (verifier side)."""
    from zkevm_tpu_torch.plonk import expr as _e

    p = FR.modulus
    if isinstance(expr, _e.Const):
        return expr.value % p
    if isinstance(expr, _e.Query):
        return ctx.query(expr.column, expr.rotation)
    if isinstance(expr, _e.GroupQuery):
        return ctx.group_query(expr.group, expr.rotation, expr.roll)
    if isinstance(expr, _e.ChallengeExpr):
        return ctx.challenge(expr.index)
    if isinstance(expr, _e.DomainX):
        return ctx.domain_x()
    if isinstance(expr, _e.Neg):
        return (-host_evaluate(expr.inner, ctx)) % p
    if isinstance(expr, _e.Sum):
        return (host_evaluate(expr.a, ctx) + host_evaluate(expr.b, ctx)) % p
    if isinstance(expr, _e.Prod):
        return (host_evaluate(expr.a, ctx) * host_evaluate(expr.b, ctx)) % p
    raise TypeError(type(expr))
