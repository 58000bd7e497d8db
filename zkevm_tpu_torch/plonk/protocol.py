"""Shared prover/verifier protocol structure (a copy of
zkevm_tpu/plonk/protocol.py): argument constraint assembly
and the multiopen query schedule.

This is the piece of halo2_proofs that lives implicitly across
plonk/{prover,verifier}.rs + {lookup,permutation,vanishing}/*.rs in the
reference's proof system (scroll-tech/halo2 v1.1): given the circuit's
ConstraintSystem plus the transcript challenges, both sides must construct
the *identical* list of quotient constraints and the identical list of
opened (polynomial, rotation) queries. Centralizing it guarantees symmetry.

Aux polynomial naming: the prover materializes arrays for these columns;
the verifier feeds claimed evals. Kinds:
- "lookup_a_perm{i}" / "lookup_s_perm{i}" / "lookup_z{i}"
- "perm_z{i}"
- virtual (not committed, evals computed by the verifier): l0, llast,
  lblind, sigma columns come from the vk (committed at keygen).
"""

from __future__ import annotations

from dataclasses import dataclass

from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.plonk.cs import Column, ConstraintSystem
from zkevm_tpu_torch.plonk.expr import Const, DomainX, Expr, Neg, Prod, Query, Sum
from zkevm_tpu_torch.plonk.keygen import DELTA


def aux(name: str) -> Column:
    return Column("aux", name)  # index field holds the name; hashable


@dataclass
class Protocol:
    """Everything both sides derive from (cs, challenges)."""

    cs: ConstraintSystem
    constraints: list  # list[(Expr, lanes)]; lanes=0 scalar, W = vector gate
    aux_columns: list  # committed aux columns in commitment order
    queries: list  # list[(Column, rotation)] opened in the multiopen
    sigma_cols: list  # Column handles for sigma polys (committed in vk)
    virtual_cols: list  # l0/llast/lblind handles (verifier-computed evals)
    perm_chunks: list  # list of lists of permutation columns
    chain_rot: int  # rotation for permutation chunk chaining (u_row)


def build_protocol(
    cs: ConstraintSystem,
    n: int,
    theta,
    beta,
    gamma,
) -> Protocol:
    """Assemble argument constraints. Gate constraints come first (in cs
    order), then lookups, then the permutation argument — the y-power
    ordering both sides use.

    theta/beta/gamma may be ints (prover/verifier) or Expr placeholders
    (the in-circuit verifier builds the SAME trees with the challenges as
    ChallengeExpr nodes resolved to witness cells)."""
    one = Const(1)

    def _c(v):
        return v if isinstance(v, Expr) else Const(v)
    l0 = aux("l0")
    llast = aux("llast")
    lblind = aux("lblind")
    active = Sum(one, Neg(Sum(Query(llast), Query(lblind))))  # 1 - (l_last+l_blind)

    constraints: list = []  # (Expr, lanes)

    def _scalar(e):
        constraints.append((e, 0))
    aux_columns: list[Column] = []
    queries: list[tuple[Column, int]] = []

    # -- circuit gates ---------------------------------------------------
    for gate in cs.gates:
        for poly in gate.polys:
            constraints.append((poly, gate.vector_width))

    # -- query schedule for circuit columns ------------------------------
    seen = set()

    def add_query(col, rot):
        if col.kind == "instance":
            return  # instances are opened by the verifier itself
        if (col, rot) not in seen:
            seen.add((col, rot))
            queries.append((col, rot))

    for gate in cs.gates:
        for poly in gate.polys:
            for col, rot in sorted(poly.queries(), key=_qkey):
                add_query(col, rot)
    for lk in cs.lookups:
        for e in lk.inputs + lk.tables:
            for col, rot in sorted(e.queries(), key=_qkey):
                add_query(col, rot)
    for col in cs.permutation_columns:
        add_query(col, 0)

    # -- lookups ---------------------------------------------------------
    def compress(exprs):
        acc = None
        for e in exprs:
            acc = e if acc is None else Sum(Prod(acc, _c(theta)), e)
        return acc if acc is not None else Const(0)

    for i, lk in enumerate(cs.lookups):
        a = compress(lk.inputs)
        s = compress(lk.tables)
        ap = aux(f"lookup_a_perm{i}")
        sp = aux(f"lookup_s_perm{i}")
        z = aux(f"lookup_z{i}")
        aux_columns += [ap, sp, z]
        b, g = _c(beta), _c(gamma)
        _scalar(Prod(Query(l0), Sum(one, Neg(Query(z)))))
        _scalar(
            Prod(Query(llast), Sum(Prod(Query(z), Query(z)), Neg(Query(z))))
        )
        _scalar(
            Prod(
                active,
                Sum(
                    Prod(
                        Query(z, 1),
                        Prod(Sum(Query(ap), b), Sum(Query(sp), g)),
                    ),
                    Neg(Prod(Query(z), Prod(Sum(a, b), Sum(s, g)))),
                ),
            )
        )
        _scalar(Prod(Query(l0), Sum(Query(ap), Neg(Query(sp)))))
        _scalar(
            Prod(
                active,
                Prod(
                    Sum(Query(ap), Neg(Query(sp))),
                    Sum(Query(ap), Neg(Query(ap, -1))),
                ),
            )
        )
        queries.append((ap, 0))
        queries.append((ap, -1))
        queries.append((sp, 0))
        queries.append((z, 0))
        queries.append((z, 1))

    # -- permutation ------------------------------------------------------
    chunk_len = cs.permutation_chunk_len()
    perm_cols = cs.permutation_columns
    chunks = [perm_cols[i : i + chunk_len] for i in range(0, len(perm_cols), chunk_len)]
    sigma_cols = [aux(f"sigma{j}") for j in range(len(perm_cols))]
    u_row = cs.usable_rows(n) - 1
    zs = []
    for ci, cols in enumerate(chunks):
        z = aux(f"perm_z{ci}")
        zs.append(z)
        aux_columns.append(z)
        b, g = _c(beta), _c(gamma)
        if ci == 0:
            _scalar(Prod(Query(l0), Sum(one, Neg(Query(z)))))
        else:
            _scalar(
                Prod(Query(l0), Sum(Query(z), Neg(Query(zs[ci - 1], u_row))))
            )
        if ci == len(chunks) - 1:
            _scalar(
                Prod(Query(llast), Sum(Prod(Query(z), Query(z)), Neg(Query(z))))
            )
        lhs = Query(z, 1)
        rhs = Query(z)
        for j, col in enumerate(cols):
            jg = ci * chunk_len + j
            sig = sigma_cols[jg]
            lhs = Prod(lhs, Sum(Query(col), Sum(Prod(b, Query(sig)), g)))
            delta_j = pow(DELTA, jg, FR_MOD)
            rhs = Prod(rhs, Sum(Query(col),
                                Sum(Prod(Prod(b, Const(delta_j)), DomainX()),
                                    g)))
        _scalar(Prod(active, Sum(lhs, Neg(rhs))))
        queries.append((z, 0))
        queries.append((z, 1))
        if ci + 1 < len(chunks):
            queries.append((z, u_row))
    for sig in sigma_cols:
        queries.append((sig, 0))

    return Protocol(
        cs=cs,
        constraints=constraints,
        aux_columns=aux_columns,
        queries=queries,
        sigma_cols=sigma_cols,
        virtual_cols=[l0, llast, lblind],
        perm_chunks=chunks,
        chain_rot=u_row,
    )


def _qkey(q):
    col, rot = q
    return (col.kind, str(col.index), rot)
