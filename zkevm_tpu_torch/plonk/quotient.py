"""The quotient evaluator (kernel M and its plain version).

Port of the reference's quotient part, ``zkevm_tpu/plonk/prover.py``
``_h_part`` (one ``jax.jit`` program per n-point part of the extended
coset, which XLA fuses): every constraint of ``protocol.constraints``
evaluated at every row of the part and folded by powers of y,
``h = h * y + v`` per scalar constraint and per lane of a vector one (the
same element as the reference's ``h * y^W + sum_z y^(W-1-z) v_z``).

A host compiler turns the constraint trees into a flat register program
(:func:`compile_constraints`); ``csrc/quotient.cu`` interprets it with one
thread per row, and :func:`plain_evaluate` runs the same program in plain
PyTorch, one field operation over all the rows per instruction.

The program:

- each distinct interior node (by ``id``) is computed once per row, and a
  node below a group query once per lane, inside the lane loop of its
  constraint; the scalar subtrees a vector constraint reads are computed
  before its lane loop and read by every lane;
- a rotated query reads the column at row (r + rot) mod n, and a group
  query in lane z reads member (z - roll) mod W of its group
  (``GroupQuery``), both in place;
- ``Sum(a, Neg(b))`` where the ``Neg`` has no other parent is one
  subtraction;
- values are registers, allocated by last use (a value that a lane loop
  reads stays live to the loop's end); constants, the challenges and y
  are rows of a constants table (y first).

Field values are canonical Montgomery words throughout, so any order of
the exact field operations gives the same words as the per-node tree walk
(:func:`h_part_by_nodes`, kept for comparison).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import torch

from zkevm_tpu_torch import kernels
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.plonk import expr as ex

# opcodes, as csrc/quotient.cu reads them; an instruction is four int32
# words (op, dst, a, b)
OP_COL = 0  # dst <- column a at row (r + b) mod n (b stored in [0, n))
OP_GROUP = 1  # dst <- column members[a + z] at row (r + b) mod n, z the lane
OP_CONST = 2  # dst <- constants table row a
OP_X = 3  # dst <- domain_x at row r
OP_ADD = 4  # dst <- reg a + reg b
OP_SUB = 5  # dst <- reg a - reg b
OP_NEG = 6  # dst <- -reg a
OP_MUL = 7  # dst <- reg a * reg b
OP_FOLD = 8  # h <- h * y + reg a
OP_LANES = 9  # lane loop of width a begins (z = 0)
OP_END_LANES = 10  # z += 1; back to the loop's first instruction while z < width
OP_END = 11

_LEAVES = (ex.Const, ex.Query, ex.GroupQuery, ex.ChallengeExpr, ex.DomainX)
# multiply instructions (a low and a high half per word product) of one
# 8-word Montgomery product, and the instructions of a field addition
MUL_INT_OPS = 2 * 64 + 8 + 2 * 64
ADD_INT_OPS = 24


@dataclass
class Program:
    """A compiled quotient part.

    ``code`` (L, 4) int32 instructions; ``members`` the group queries'
    column lists, each already rolled (entry z is the column lane z
    reads); ``consts`` the constant values (rows 1.. of the constants
    table; row 0 is y, the challenges follow); ``n_regs`` the peak number
    of live registers; ``muls`` / ``adds`` the field products and
    additions (subtractions, negations) per row, each lane counted."""

    code: np.ndarray
    members: np.ndarray
    consts: list
    n_challenges: int
    n_regs: int
    n_rows: int
    muls: int
    adds: int

    def int_ops(self) -> int:
        """Multiply instructions of one part (every row)."""
        return self.n_rows * (self.muls * MUL_INT_OPS + self.adds * ADD_INT_OPS)

    def describe(self) -> str:
        return (f"{len(self.code)} instructions, {self.n_regs} registers at peak, "
                f"{len(self.consts)} constants, {len(self.members)} group members, "
                f"{self.muls} products and {self.adds} additions a row")


class _Builder:
    """Lowers constraint trees to SSA instructions, then allocates registers."""

    def __init__(self, cols_order: list, n: int):
        self.col_index = {c: i for i, c in enumerate(cols_order)}
        self.n = n
        self.ins: list = []  # (op, dst value or None, source values, imm a, imm b)
        self.n_values = 0
        self.consts: dict[int, int] = {}  # value -> constants-table row
        self.n_challenges = 0
        self.members: list[int] = []
        self.member_at: dict[tuple, int] = {}
        self.vec: dict[int, bool] = {}
        self.parents: dict[int, int] = {}
        self.scalar_memo: dict[int, int] = {}  # interior scalar nodes, whole program
        self.muls = self.adds = 0

    # -- analysis ---------------------------------------------------------
    def count_parents(self, e, seen: set) -> None:
        if id(e) in seen:
            return
        seen.add(id(e))
        for c in _children(e):
            self.parents[id(c)] = self.parents.get(id(c), 0) + 1
            self.count_parents(c, seen)

    def is_vec(self, e) -> bool:
        v = self.vec.get(id(e))
        if v is None:
            if isinstance(e, ex.GroupQuery):
                v = True
            else:
                v = any(self.is_vec(c) for c in _children(e))
            self.vec[id(e)] = v
        return v

    # -- emission ---------------------------------------------------------
    def _emit(self, op, srcs=(), a=0, b=0, value=True) -> int | None:
        dst = None
        if value:
            dst = self.n_values
            self.n_values += 1
        self.ins.append((op, dst, tuple(srcs), a, b))
        return dst

    def _const_row(self, v: int) -> int:
        v %= FR_MOD
        if v not in self.consts:
            self.consts[v] = len(self.consts)
        return 1 + self.consts[v]

    def _column(self, col) -> int:
        if col not in self.col_index:
            raise KeyError(f"quotient: column {col!r} is queried but not in cols_order")
        return self.col_index[col]

    def _leaf(self, e, lane_width: int) -> int:
        if isinstance(e, ex.Const):
            return self._emit(OP_CONST, a=self._const_row(e.value))
        if isinstance(e, ex.ChallengeExpr):
            self.n_challenges = max(self.n_challenges, e.index + 1)
            return self._emit(OP_CONST, a=-1 - e.index)  # resolved in finish()
        if isinstance(e, ex.DomainX):
            return self._emit(OP_X)
        if isinstance(e, ex.Query):
            return self._emit(OP_COL, a=self._column(e.column), b=e.rotation % self.n)
        # GroupQuery: lane z reads member (z - roll) mod W
        cols = e.group.columns
        w = len(cols)
        if w != lane_width:
            raise ValueError(f"quotient: group {e.group.name!r} of width {w} in a constraint of "
                             f"{lane_width} lanes")
        key = (id(e.group), e.roll % w)
        if key not in self.member_at:
            self.member_at[key] = len(self.members)
            self.members += [self._column(cols[(z - e.roll) % w]) for z in range(w)]
        return self._emit(OP_GROUP, a=self.member_at[key], b=e.rotation % self.n)

    def emit(self, e, local: dict, lanes: int) -> int:
        """Value of node ``e`` in a constraint of ``lanes`` lanes. Interior
        scalar nodes are memoised for the whole program, leaves and vector
        nodes in ``local`` (one constraint)."""
        key = id(e)
        vec = self.is_vec(e)
        leaf = isinstance(e, _LEAVES)
        memo = local if (leaf or vec) else self.scalar_memo
        if key in memo:
            return memo[key]
        if leaf:
            val = self._leaf(e, lanes)
        else:
            weight = lanes if vec else 1
            if isinstance(e, ex.Neg):
                val = self._emit(OP_NEG, [self.emit(e.inner, local, lanes)])
                self.adds += weight
            elif isinstance(e, ex.Prod):
                a = self.emit(e.a, local, lanes)
                val = self._emit(OP_MUL, [a, self.emit(e.b, local, lanes)])
                self.muls += weight
            elif isinstance(e, ex.Sum):
                a = self.emit(e.a, local, lanes)
                if self._fuses(e):
                    val = self._emit(OP_SUB, [a, self.emit(e.b.inner, local, lanes)])
                else:
                    val = self._emit(OP_ADD, [a, self.emit(e.b, local, lanes)])
                self.adds += weight
            else:
                raise TypeError(f"quotient: unknown expression node {type(e).__name__}")
        memo[key] = val
        return val

    def _fuses(self, e) -> bool:
        """Sum(a, Neg(b)) is one subtraction where the Neg has no other
        parent (so no other node reads its value) and is as vector as the
        Sum."""
        return (isinstance(e.b, ex.Neg) and self.parents.get(id(e.b), 0) == 1
                and self.is_vec(e.b) == self.is_vec(e))

    def hoist(self, e, local: dict, lanes: int, seen: set) -> None:
        """Emit, before a lane loop, every scalar subtree that a vector node
        of ``e`` reads."""
        if id(e) in seen:
            return
        seen.add(id(e))
        kids = _children(e)
        if isinstance(e, ex.Sum) and self._fuses(e):
            kids = (e.a, e.b.inner)
        for c in kids:
            if self.is_vec(c):
                self.hoist(c, local, lanes, seen)
            else:
                self.emit(c, local, lanes)

    def constraint(self, e, lanes: int) -> None:
        local: dict = {}
        if not lanes:
            self._emit(OP_FOLD, [self.emit(e, local, 0)], value=False)
            self.muls += 1
            self.adds += 1
            return
        if self.is_vec(e):
            self.hoist(e, local, lanes, set())
            self._emit(OP_LANES, a=lanes, value=False)
            v = self.emit(e, local, lanes)
        else:  # a scalar value folds into every lane
            v = self.emit(e, local, lanes)
            self._emit(OP_LANES, a=lanes, value=False)
        self._emit(OP_FOLD, [v], value=False)
        self._emit(OP_END_LANES, value=False)
        self.muls += lanes
        self.adds += lanes

    # -- register allocation ----------------------------------------------
    def finish(self, n_rows: int) -> Program:
        self._emit(OP_END, value=False)
        ins = self.ins
        last = {}
        loop_start = None
        defined_at = {}
        for i, (op, dst, srcs, _, _) in enumerate(ins):
            if op == OP_LANES:
                loop_start = i
            for s in srcs:
                last[s] = i
            if op == OP_END_LANES:
                # a value defined before the loop and read inside it stays
                # live until the loop ends
                for s, at in list(last.items()):
                    if at > loop_start and defined_at[s] < loop_start:
                        last[s] = i
                loop_start = None
            if dst is not None:
                defined_at[dst] = i
        free: list[int] = []
        reg_of: dict[int, int] = {}
        n_regs = 0
        deaths: dict[int, list] = {}
        for v, i in last.items():
            deaths.setdefault(i, []).append(v)
        n_ch_base = 1 + len(self.consts)
        code = np.zeros((len(ins), 4), np.int64)
        for i, (op, dst, srcs, a, b) in enumerate(ins):
            regs = [reg_of[s] for s in srcs]
            for v in deaths.get(i, ()):
                heapq.heappush(free, reg_of[v])
            r = 0
            if dst is not None:
                if free:
                    r = heapq.heappop(free)
                else:
                    r = n_regs
                    n_regs += 1
                reg_of[dst] = r
                if dst not in last:  # never read (cannot happen for a folded tree)
                    heapq.heappush(free, r)
            if op == OP_CONST and a < 0:
                a = n_ch_base + (-1 - a)
            if op in (OP_ADD, OP_SUB, OP_MUL):
                a, b = regs
            elif op in (OP_NEG, OP_FOLD):
                a = regs[0]
            code[i] = (op, r, a, b)
        members = np.asarray(self.members, np.int64)
        return Program(code=code.astype(np.int32), members=members.astype(np.int32),
                       consts=list(self.consts), n_challenges=self.n_challenges, n_regs=n_regs,
                       n_rows=n_rows, muls=self.muls, adds=self.adds)


def _children(e) -> tuple:
    if isinstance(e, ex.Neg):
        return (e.inner,)
    if isinstance(e, (ex.Sum, ex.Prod)):
        return (e.a, e.b)
    return ()


def queried_columns(constraints: list) -> list:
    """Every column the constraint trees query, in the order first met."""
    cols: dict = {}
    seen: set = set()
    stack = [e for e, _ in reversed(constraints)]
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        if isinstance(e, ex.Query):
            cols.setdefault(e.column, None)
        elif isinstance(e, ex.GroupQuery):
            cols.update((c, None) for c in e.group.columns if c not in cols)
        stack += reversed(_children(e))
    return list(cols)


def compile_constraints(constraints: list, cols_order: list, n: int) -> Program:
    """The register program of one quotient part: ``constraints`` is
    ``protocol.constraints`` ((tree, lanes) pairs, lanes 0 for a scalar
    constraint), ``cols_order`` the columns of ``part_vals`` in order, ``n``
    the rows of a part."""
    b = _Builder(cols_order, n)
    seen: set = set()
    for e, _ in constraints:
        b.count_parents(e, seen)
    for e, width in constraints:
        b.constraint(e, width)
    return b.finish(n)


def constants_table(prog: Program, y: int, ch_mont: list, device) -> torch.Tensor:
    """(1 + constants + challenges, 8) Montgomery rows: y, the program's
    constants, then the challenges (``ch_mont``, (8,) tensors)."""
    table = ff.to_tensor(FR.encode_many([y] + prog.consts), device)
    if prog.n_challenges:
        table = torch.cat([table, torch.stack([c.to(table.device) for c in ch_mont[:prog.n_challenges]])])
    return table


# ---------------------------------------------------------------------------
# Plain version: the same program, one plain field operation per instruction
# ---------------------------------------------------------------------------

def plain_evaluate(prog: Program, part_vals: torch.Tensor, domain_x: torch.Tensor,
                   consts: torch.Tensor, rows=None, lanewise: bool = False) -> torch.Tensor:
    """The part's folded numerator at ``rows`` (all n rows by default), as
    (rows, 8) words, on any device.

    A lane loop runs once over all its lanes at a time, vector values being
    (rows, W, 8), and folds them as ``h * y^W + sum_z y^(W-1-z) v_z``;
    ``lanewise=True`` runs it lane by lane and folds each lane in turn, as
    kernel M does (slower; it exercises the register allocation inside the
    loop)."""
    add, sub, mul = ff.PLAIN["add"], ff.PLAIN["sub"], ff.PLAIN["mul"]
    dev = part_vals.device
    n = part_vals.shape[1]
    idx = (torch.arange(n, device=dev) if rows is None
           else torch.as_tensor(rows, dtype=torch.int64).to(dev))
    m = idx.numel()
    y = consts[0]
    regs: list = [None] * prog.n_regs
    h = torch.zeros(m, ff.W, dtype=torch.int32, device=dev)
    members = prog.members.tolist()
    code = prog.code.tolist()
    width = z = loop_pc = 0
    in_loop = False
    ypows: dict[int, tuple] = {}

    def at(rot: int) -> torch.Tensor:
        return idx if rot == 0 else (idx + rot) % n

    def reg(r: int) -> torch.Tensor:
        t = regs[r]
        # inside a loop run over all lanes, a per-row scalar meets (rows, W, 8)
        if in_loop and not lanewise and t.dim() == 2:
            return t[:, None]
        return t

    def fold_lanes(h, v):
        if width not in ypows:  # (y^(W-1-z))_z and y^W
            p = [FR.mont_one(dev)]
            for _ in range(width):
                p.append(mul(FR, p[-1], y))
            ypows[width] = (torch.stack(p[width - 1::-1]), p[width])
        pw, yw = ypows[width]
        v = v.expand(m, width, ff.W) if v.dim() < 3 else v
        terms = mul(FR, v, pw)
        s = terms[:, 0]
        for lane in range(1, width):  # any order: field additions are exact
            s = add(FR, s, terms[:, lane])
        return add(FR, mul(FR, h, yw), s)

    pc = 0
    while True:
        op, d, a, b = code[pc]
        if op == OP_COL:
            regs[d] = part_vals[a].index_select(0, at(b))
        elif op == OP_GROUP:
            if lanewise:
                regs[d] = part_vals[members[a + z]].index_select(0, at(b))
            else:
                cols = torch.tensor(members[a:a + width], dtype=torch.int64, device=dev)
                regs[d] = part_vals[cols[:, None], at(b)[None, :]].transpose(0, 1)
        elif op == OP_CONST:
            regs[d] = consts[a]
        elif op == OP_X:
            regs[d] = domain_x.index_select(0, idx)
        elif op == OP_ADD:
            regs[d] = add(FR, reg(a), reg(b))
        elif op == OP_SUB:
            regs[d] = sub(FR, reg(a), reg(b))
        elif op == OP_NEG:
            x = reg(a)
            regs[d] = sub(FR, torch.zeros_like(x), x)
        elif op == OP_MUL:
            regs[d] = mul(FR, reg(a), reg(b))
        elif op == OP_FOLD:
            if in_loop and not lanewise:
                h = fold_lanes(h, reg(a))
            else:
                h = add(FR, mul(FR, h, y), reg(a)).expand(m, ff.W)
        elif op == OP_LANES:
            width, z, loop_pc, in_loop = a, 0, pc, True
        elif op == OP_END_LANES:
            if lanewise and z + 1 < width:
                z += 1
                pc = loop_pc
            else:
                in_loop = False
        elif op == OP_END:
            return h.contiguous()
        else:
            raise ValueError(f"quotient: bad opcode {op} at {pc}")
        pc += 1


# ---------------------------------------------------------------------------
# Kernel M
# ---------------------------------------------------------------------------

MAX_REGS = 56  # csrc/quotient.cu's register file: 128 threads x 32 bytes each in 227 KB of shared memory


def _check_program(prog: Program, n_cols: int, n_consts: int) -> None:
    """Every index the kernel follows lies inside its array (the kernel
    itself checks none)."""
    code = prog.code.astype(np.int64)
    op, dst, a, b = code.T
    regs = (op <= OP_MUL)
    reads_a = np.isin(op, (OP_ADD, OP_SUB, OP_NEG, OP_MUL, OP_FOLD))
    reads_b = np.isin(op, (OP_ADD, OP_SUB, OP_MUL))
    bad = ((regs & ((dst < 0) | (dst >= prog.n_regs)))
           | (reads_a & ((a < 0) | (a >= prog.n_regs))) | (reads_b & ((b < 0) | (b >= prog.n_regs)))
           | ((op == OP_COL) & ((a < 0) | (a >= n_cols)))
           | ((op == OP_CONST) & ((a < 0) | (a >= n_consts)))
           | (np.isin(op, (OP_COL, OP_GROUP)) & ((b < 0) | (b >= prog.n_rows)))
           | ((op == OP_LANES) & (a < 1)) | (op < 0) | (op > OP_END))
    groups = code[op == OP_GROUP]
    widths = np.zeros(len(code), np.int64)
    width = 0
    for i, (o, _, w, _) in enumerate(code.tolist()):
        width = w if o == OP_LANES else width
        widths[i] = width
    gw = widths[op == OP_GROUP]
    bad_groups = (groups[:, 2] < 0) | (groups[:, 2] + gw > len(prog.members)) | (gw < 1)
    if bad.any() or bad_groups.any() or op[-1] != OP_END or (
            len(prog.members) and (prog.members.min() < 0 or prog.members.max() >= n_cols)):
        raise ValueError("quotient: the program indexes outside its inputs")


def _launch(prog: Program, part_vals: torch.Tensor, domain_x: torch.Tensor,
            consts: torch.Tensor) -> torch.Tensor:
    kernels.check_cuda_tensor("part_vals", part_vals, torch.int32, ff.W)
    kernels.check_cuda_tensor("domain_x", domain_x, torch.int32, ff.W)
    kernels.check_cuda_tensor("consts", consts, torch.int32, ff.W)
    if part_vals.dim() != 3 or domain_x.shape != (part_vals.shape[1], ff.W):
        raise ValueError(f"quotient: expected part_vals (C, n, 8) and domain_x (n, 8), got "
                         f"{tuple(part_vals.shape)} and {tuple(domain_x.shape)}")
    n = part_vals.shape[1]
    if n != prog.n_rows:
        raise ValueError(f"quotient: program compiled for {prog.n_rows} rows, part has {n}")
    _check_program(prog, part_vals.shape[0], consts.shape[0])
    if prog.n_regs > MAX_REGS:
        raise ValueError(f"quotient: the program needs {prog.n_regs} registers; kernel M holds {MAX_REGS}")
    dev = part_vals.device
    code = torch.from_numpy(prog.code).to(dev)
    members = torch.from_numpy(np.append(prog.members, 0).astype(np.int32)).to(dev)
    out = torch.empty(n, ff.W, dtype=torch.int32, device=dev)
    kernels.launch("quotient", "quotient", "zk_quotient_part", out.data_ptr(), part_vals.data_ptr(),
                   domain_x.data_ptr(), consts.data_ptr(), code.data_ptr(), members.data_ptr(), n,
                   prog.n_regs)
    return out


def evaluate(prog: Program, part_vals: torch.Tensor, domain_x: torch.Tensor,
             consts: torch.Tensor) -> torch.Tensor:
    """The part's folded numerator, (n, 8): kernel M on CUDA tensors (one
    launch), the plain version on CPU ones."""
    devs = {part_vals.device.type, domain_x.device.type, consts.device.type}
    if devs == {"cpu"}:
        return plain_evaluate(prog, part_vals, domain_x, consts)
    if devs != {"cuda"}:
        raise ValueError(f"quotient: unsupported devices {devs}")
    return _launch(prog, part_vals, domain_x, consts)


def h_part(protocol, cols_order: list, part_vals: torch.Tensor, domain_x: torch.Tensor,
           ch_mont: list, y: int) -> torch.Tensor:
    """One n-point part of the quotient's numerator: every constraint of
    ``protocol`` evaluated on ``part_vals`` ((columns, n, 8), in
    ``cols_order``), folded by powers of y."""
    prog = compile_constraints(protocol.constraints, cols_order, part_vals.shape[1])
    return evaluate(prog, part_vals, domain_x, constants_table(prog, y, ch_mont, part_vals.device))


def h_part_by_nodes(protocol, cols_order: list, part_vals: torch.Tensor, domain_x: torch.Tensor,
                    ch_mont: list, y: int) -> torch.Tensor:
    """The same part by the per-node tree walk (``Expr.evaluate``): one
    field operation over all n rows per tree node, a copy per rotation
    and per rolled group. Kept to hold kernel M and its plain version to."""
    dev = part_vals.device
    n = part_vals.shape[1]
    ctx = ex.EvalContext({c: part_vals[idx] for idx, c in enumerate(cols_order)}, ch_mont, dev)
    ctx.set_domain_x(domain_x)
    y_m = FR.const(y, dev)
    hj = torch.zeros(n, ff.W, dtype=torch.int32, device=dev)
    for con, width in protocol.constraints:
        v = con.evaluate(ctx)
        if width:
            # vector constraint (n, W, 8): fold lanes by y^(W-1-z),
            # the same as W sequential scalar folds (verifier view)
            ypows = ff.to_tensor(FR.encode_many(
                [pow(y, width - 1 - z, FR_MOD) for z in range(width)]), dev)
            fold = ff.sum_rows(FR, ff.mont_mul(FR, v, ypows), dim=1)
            hj = ff.add(FR, ff.mont_mul(FR, hj, FR.const(pow(y, width, FR_MOD), dev)), fold)
        else:
            hj = ff.add(FR, ff.mont_mul(FR, hj, y_m), v)
    return hj
