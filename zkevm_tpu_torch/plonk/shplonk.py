"""SHPLONK (BDFG21) multi-point opening, prover and verifier halves.

Port of ``zkevm_tpu/plonk/shplonk.py``. Scheme (BDFG21 "scheme 2"):
- group polynomials by their point set S_i; T = union of points;
- inner RLC: every poly gets weight v^{g} by global order g;
- H(X) = sum_i (F_i(X) - r_i(X)) / Z_{S_i}(X), commit;
- challenge u; L(X) = sum_i Z_{T\\S_i}(u) * (F_i(X) - r_i(u)) - Z_T(u) H(X);
- W = L / (X - u), commit; check e(L + u W, G2) = e(W, [tau]G2).

The prover's quotients are computed in evaluation form on the size-n coset
g*H with the field and NTT kernels (every division is a pointwise multiply
by a batched inverse); the verifier half is host code.
"""

from __future__ import annotations

import torch

from zkevm_tpu_torch.ec import goldens as g1g, group, pairing as pr
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.kzg.params import ParamsKZG
from zkevm_tpu_torch.poly import ntt as nttmod
from zkevm_tpu_torch.poly.domain import Domain


def _group_queries(queries):
    """queries: list of (label, handle, point, eval). Labels give both
    sides an identical grouping (array ids / commitment values can
    collide). Returns {point_set: [entry]} with stable global indices."""
    by_label = {}
    order = []
    for label, h, pt, ev in queries:
        if label not in by_label:
            by_label[label] = {"handle": h, "points": {}, "gidx": len(order)}
            order.append(label)
        by_label[label]["points"][pt] = ev
    groups: dict[tuple, list] = {}
    for label in order:
        e = by_label[label]
        pts = tuple(sorted(e["points"]))
        groups.setdefault(pts, []).append(e)
    return groups


def _vanishing_eval(points, x: int) -> int:
    acc = 1
    for p in points:
        acc = acc * (x - p) % FR_MOD
    return acc


def _interp_eval(points, evals, x: int) -> int:
    """Lagrange-interpolate (points -> evals) and evaluate at x."""
    acc = 0
    for i, pi in enumerate(points):
        num, den = 1, 1
        for j, pj in enumerate(points):
            if i == j:
                continue
            num = num * (x - pj) % FR_MOD
            den = den * (pi - pj) % FR_MOD
        acc = (acc + evals[i] * num * pow(den, FR_MOD - 2, FR_MOD)) % FR_MOD
    return acc


def open_many(params: ParamsKZG, domain: Domain, queries, transcript):
    """Prover half. queries: list of (label, coeff tensor (n, 8), point
    int, eval int). Returns (h_commitment, w_commitment) as affine pairs,
    and absorbs them into the transcript."""
    n = domain.n
    dev = params.device
    shift = domain.g_coset
    v = transcript.challenge()

    groups = _group_queries(queries)
    coset_m = ff.mont_mul(FR, nttmod.power_table(domain.omega, n, dev), FR.const(shift, dev))

    # H(X) = sum_i (F_i - r_i) / Z_{S_i} computed on the coset
    h_evals = None
    group_data = []
    for pts, entries in groups.items():
        f_coeff = None
        for e in entries:
            term = ff.mont_mul(FR, e["handle"], FR.const(pow(v, e["gidx"], FR_MOD), dev))
            f_coeff = term if f_coeff is None else ff.add(FR, f_coeff, term)
        combined_evals = []
        for pt in pts:
            acc = 0
            for e in entries:
                acc = (acc + pow(v, e["gidx"], FR_MOD) * e["points"][pt]) % FR_MOD
            combined_evals.append(acc)
        group_data.append((pts, f_coeff, combined_evals))

        r_on_coset = _eval_small_poly_on(coset_m, _interp_coeffs(pts, combined_evals))
        num = ff.sub(FR, nttmod.coset_ntt(f_coeff, shift), r_on_coset)
        zs = None
        for pt in pts:
            d = ff.sub(FR, coset_m, FR.const(pt, dev))
            zs = d if zs is None else ff.mont_mul(FR, zs, d)
        term = ff.mont_mul(FR, num, ff.inv(FR, zs))
        h_evals = term if h_evals is None else ff.add(FR, h_evals, term)

    h_coeff = nttmod.coset_intt(h_evals, shift)
    h_comm = group.to_affine_ints(params.commit(h_coeff))[0]
    transcript.common_point(h_comm)
    u = transcript.challenge()

    # L(X) = sum_i Z_{T\S_i}(u) (F_i(X) - r_i(u)) - Z_T(u) H(X)
    all_pts = sorted({pt for pts, _, _ in group_data for pt in pts})
    zt_u = _vanishing_eval(all_pts, u)
    l_coeff = None
    for pts, f_coeff, combined_evals in group_data:
        others = [p for p in all_pts if p not in pts]
        w_u = _vanishing_eval(others, u)
        r_u = _interp_eval(list(pts), combined_evals, u)
        term = ff.mont_mul(FR, f_coeff, FR.const(w_u, dev))
        # subtract w_u * r_u from the constant coefficient
        term[0] = ff.sub(FR, term[0], FR.const(w_u * r_u % FR_MOD, dev))
        l_coeff = term if l_coeff is None else ff.add(FR, l_coeff, term)
    l_coeff = ff.sub(FR, l_coeff, ff.mont_mul(FR, h_coeff, FR.const(zt_u, dev)))

    # W = L / (X - u) on the coset
    den = ff.sub(FR, coset_m, FR.const(u, dev))
    w_evals = ff.mont_mul(FR, nttmod.coset_ntt(l_coeff, shift), ff.inv(FR, den))
    w_coeff = nttmod.coset_intt(w_evals, shift)
    w_comm = group.to_affine_ints(params.commit(w_coeff))[0]
    transcript.common_point(w_comm)
    return h_comm, w_comm


def _interp_coeffs(points, evals) -> list[int]:
    """Lagrange interpolation -> coefficient list (small |points|)."""
    m = len(points)
    coeffs = [0] * m
    for i, pi in enumerate(points):
        # basis poly prod_{j!=i} (X - pj) / (pi - pj)
        basis = [1]
        den = 1
        for j, pj in enumerate(points):
            if i == j:
                continue
            # multiply basis by (X - pj)
            nxt = [0] * (len(basis) + 1)
            for d, c in enumerate(basis):
                nxt[d] = (nxt[d] - c * pj) % FR_MOD
                nxt[d + 1] = (nxt[d + 1] + c) % FR_MOD
            basis = nxt
            den = den * (pi - pj) % FR_MOD
        scale = evals[i] * pow(den, FR_MOD - 2, FR_MOD) % FR_MOD
        for d, c in enumerate(basis):
            coeffs[d] = (coeffs[d] + c * scale) % FR_MOD
    return coeffs


def _eval_small_poly_on(xs_m: torch.Tensor, coeffs: list[int]) -> torch.Tensor:
    """Evaluate a small host polynomial on a device point tensor (Horner)."""
    dev = xs_m.device
    acc = torch.zeros_like(xs_m)
    for c in reversed(coeffs):
        acc = ff.add(FR, ff.mont_mul(FR, acc, xs_m), FR.const(c, dev))
    return acc


def verify_many_with_proof(
    params: ParamsKZG, queries, h_comm, w_comm, transcript
) -> bool:
    """queries: list of (label, commitment_handle, point, eval); handle is
    an affine pair or [(scalar, affine), ...] combo. Must use the prover's
    labels and query order."""
    v = transcript.challenge()
    groups = _group_queries(queries)

    transcript.common_point(h_comm)
    u = transcript.challenge()

    def resolve(h):
        """handle -> affine point (combining combos on the host)."""
        if isinstance(h, list):
            acc = None
            for s, c in h:
                acc = g1g.add(acc, g1g.scalar_mul(c, s))
            return acc
        return h

    all_pts = sorted({pt for pts in groups for pt in pts})
    zt_u = _vanishing_eval(all_pts, u)

    # C_L = sum_i w_i(u) * (C_{F_i}) - [sum_i w_i(u) r_i(u)] G1 - Z_T(u) C_H
    c_l = None
    scalar_acc = 0
    for pts, entries in groups.items():
        others = [p for p in all_pts if p not in pts]
        w_u = _vanishing_eval(others, u)
        c_f = None
        combined_evals = []
        for pt in pts:
            acc = 0
            for e in entries:
                acc = (acc + pow(v, e["gidx"], FR_MOD) * e["points"][pt]) % FR_MOD
            combined_evals.append(acc)
        for e in entries:
            w = pow(v, e["gidx"], FR_MOD)
            c_f = g1g.add(c_f, g1g.scalar_mul(resolve(e["handle"]), w))
        r_u = _interp_eval(list(pts), combined_evals, u)
        c_l = g1g.add(c_l, g1g.scalar_mul(c_f, w_u))
        scalar_acc = (scalar_acc + w_u * r_u) % FR_MOD
    c_l = g1g.add(c_l, g1g.scalar_mul(g1g.G1_GEN, (-scalar_acc) % FR_MOD))
    c_l = g1g.add(c_l, g1g.scalar_mul(h_comm, (-zt_u) % FR_MOD))

    transcript.common_point(w_comm)
    # e(C_L + u W, G2) * e(-W, [tau]G2) == 1
    lhs = g1g.add(c_l, g1g.scalar_mul(w_comm, u))
    return pr.pairing_check([(lhs, pr.G2_GEN), (g1g.neg(w_comm), params.s_g2)])
