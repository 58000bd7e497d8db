"""The PLONKish prover: create_proof.

Port of ``zkevm_tpu/plonk/prover.py``, step for step, so that with an
integer ``seed`` the port's ``Proof`` equals the reference's field by field:
the transcript schedule, the blinding stream (``_BlindSampler``, copied
exactly) and every polynomial are the same. Device work runs on the
params' device through the port's kernels:

- column commitments: iNTT (kernel B) + MSM (kernel C);
- grand products: factors and a Fermat inversion (kernel A) and a log-step
  prefix product (``prefix_product``, launches of kernel A);
- quotient: every constraint tree evaluated per n-point part of the
  extended coset and y-folded by one launch of kernel M (``_h_part``,
  ``plonk/quotient.py``), then divided by Z_H;
- multiopen: SHPLONK (``plonk/shplonk.py``).

Host work is the transcript bytes and the lookup permutation ordering.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

import numpy as np
import torch

from zkevm_tpu_torch.ec import group
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.kzg.params import ParamsKZG
from zkevm_tpu_torch.plonk import quotient, shplonk
from zkevm_tpu_torch.plonk.assign import Assignment
from zkevm_tpu_torch.plonk.expr import EvalContext
from zkevm_tpu_torch.plonk.keygen import ProvingKey
from zkevm_tpu_torch.plonk.protocol import aux, build_protocol
from zkevm_tpu_torch.poly import ntt as nttmod
from zkevm_tpu_torch.transcript import KeccakTranscript, PoseidonTranscript

L16 = 16  # limbs of the reference's blinding rows

prefix_product = ff.prefix_product


@dataclass
class Proof:
    advice_commitments: list  # affine pairs, cs.advice_columns order
    lookup_permuted: list  # (a_comm, s_comm) per lookup
    perm_z_commitments: list
    lookup_z_commitments: list
    random_commitment: tuple
    h_commitments: list
    evals: list  # ints, protocol query order (+ random poly eval last)
    shplonk_h: tuple
    shplonk_w: tuple


def _pt_json(p):
    return None if p is None else [int(p[0]), int(p[1])]


def _pt_tuple(p):
    return None if p is None else (int(p[0]), int(p[1]))


def proof_to_json(proof) -> dict:
    """A Proof (of this package or the reference's, whose fields are the
    same) as JSON-ready lists of ints."""
    return {
        "advice_commitments": [_pt_json(p) for p in proof.advice_commitments],
        "lookup_permuted": [[_pt_json(a), _pt_json(b)] for a, b in proof.lookup_permuted],
        "perm_z_commitments": [_pt_json(p) for p in proof.perm_z_commitments],
        "lookup_z_commitments": [_pt_json(p) for p in proof.lookup_z_commitments],
        "random_commitment": _pt_json(proof.random_commitment),
        "h_commitments": [_pt_json(p) for p in proof.h_commitments],
        "evals": [int(v) for v in proof.evals],
        "shplonk_h": _pt_json(proof.shplonk_h),
        "shplonk_w": _pt_json(proof.shplonk_w),
    }


def proof_fields(d: dict) -> dict:
    """Inverse of proof_to_json: keyword arguments for either package's Proof."""
    return {
        "advice_commitments": [_pt_tuple(p) for p in d["advice_commitments"]],
        "lookup_permuted": [(_pt_tuple(a), _pt_tuple(b)) for a, b in d["lookup_permuted"]],
        "perm_z_commitments": [_pt_tuple(p) for p in d["perm_z_commitments"]],
        "lookup_z_commitments": [_pt_tuple(p) for p in d["lookup_z_commitments"]],
        "random_commitment": _pt_tuple(d["random_commitment"]),
        "h_commitments": [_pt_tuple(p) for p in d["h_commitments"]],
        "evals": [int(v) for v in d["evals"]],
        "shplonk_h": _pt_tuple(d["shplonk_h"]),
        "shplonk_w": _pt_tuple(d["shplonk_w"]),
    }


def _commit(params: ParamsKZG, coeff: torch.Tensor) -> tuple:
    return group.to_affine_ints(params.commit(coeff))[0]


def _powers_table(x: int, n: int, device) -> torch.Tensor:
    """[1, x, x^2, ...] in Montgomery form, by a device prefix product."""
    return prefix_product(FR, FR.const(x, device).expand(n, ff.W))


def eval_polys_at(coeff_stack: torch.Tensor, x: int) -> list[int]:
    """(m, n, 8) coefficient stack -> [poly_i(x)] as ints."""
    n = coeff_stack.shape[1]
    terms = ff.mont_mul(FR, coeff_stack, _powers_table(x, n, coeff_stack.device))
    return FR.decode_many(ff.sum_rows(FR, terms, dim=1))


_FR_LIMBS = np.asarray([(FR_MOD >> (16 * i)) & 0xFFFF for i in range(L16)], np.uint32)


class _BlindSampler:
    """Uniform-in-Fr blinding source, vectorized. seed=None (the
    public-API default) draws from the OS CSPRNG; an explicit int seed
    gives a deterministic stream for tests/reproduction only -- never
    default to a constant (zero-knowledge requires unpredictable,
    full-field blinds).

    rows(count) returns (count, 16) uint32 limb arrays uniform in
    [0, FR_MOD) by masked rejection sampling (254-bit candidates, ~76%
    acceptance) -- these are written directly as polynomial-storage
    (Montgomery-domain) values: a uniform representation IS a uniform
    field element, no conversion needed for blinding rows.

    A copy of the reference's sampler, so a seed gives the same stream.
    """

    def __init__(self, seed):
        self._rng = None if seed is None else np.random.default_rng(seed)

    def _bytes(self, count: int) -> np.ndarray:
        if self._rng is None:
            raw = secrets.token_bytes(count)
        else:
            raw = self._rng.bytes(count)
        return np.frombuffer(raw, dtype=np.uint8)

    def rows(self, count: int) -> np.ndarray:
        if count == 0:
            return np.zeros((0, L16), np.uint32)
        cand = (
            self._bytes(count * 32)
            .view("<u2")
            .reshape(count, L16)
            .astype(np.uint32)
        )
        cand[:, 15] &= 0x3FFF  # < 2^254
        p = _FR_LIMBS
        lt = np.zeros(count, bool)
        gt = np.zeros(count, bool)
        for i in range(L16 - 1, -1, -1):
            li, pi = cand[:, i], p[i]
            lt |= ~gt & (li < pi)
            gt |= ~lt & (li > pi)
        bad = ~lt
        if bad.any():
            cand[bad] = self.rows(int(bad.sum()))
        return cand

    def words(self, count: int) -> np.ndarray:
        """rows(count) in the port's (count, 8) word layout."""
        return ff.words_from_limbs16(self.rows(count))


def _lex_order(rows: np.ndarray) -> np.ndarray:
    """Stable order sorting (m, 8) word rows by integer value (word 7 most
    significant). Any total order works for the lookup permutation; this
    one equals the reference's limb order, so the proofs agree."""
    return np.lexsort(rows.T)


def dense_ranks(rows: np.ndarray) -> np.ndarray:
    """(m, c) uint32 word rows (c even) -> (m,) dense ranks: equal rows
    share a rank, and ranks follow the rows' order as integers whose last
    word is the most significant. The same ranks as
    ``np.unique(rows[:, ::-1], axis=0, return_inverse=True)``, which sorts
    the rows as structured records (~10 s for 2^21 rows of 8 words); a
    lexsort over 64-bit word pairs takes a twentieth of that."""
    w = rows.astype(np.uint64)
    keys = [w[:, i] | (w[:, i + 1] << np.uint64(32)) for i in range(0, rows.shape[1], 2)]
    order = np.lexsort(keys)  # the last key (most significant pair) is the primary one
    srt = rows[order]
    new = np.ones(rows.shape[0], bool)
    new[1:] = np.any(srt[1:] != srt[:-1], axis=1)
    ranks = np.empty(rows.shape[0], np.int64)
    ranks[order] = np.cumsum(new) - 1
    return ranks


def _permute_lookup(a_mont: np.ndarray, s_mont: np.ndarray, active: int, n: int,
                    blinds: _BlindSampler):
    """halo2 lookup::permute_expression_pair on host numpy: returns (a', s')
    as (n, 8) uint32 Montgomery words (tails random)."""
    a_act = np.asarray(a_mont)[:active]
    s_act = np.asarray(s_mont)[:active]
    a_sorted = a_act[_lex_order(a_act)]
    s_sorted = s_act[_lex_order(s_act)]

    heads = np.ones(active, bool)
    heads[1:] = np.any(a_sorted[1:] != a_sorted[:-1], axis=1)

    # dense per-row rank ids shared by both arrays, in _lex_order's
    # integer order
    inv = dense_ranks(np.concatenate([a_sorted, s_sorted]))
    a_rank, s_rank = inv[:active], inv[active:]

    distinct = a_rank[heads]
    first = np.searchsorted(s_rank, distinct, side="left")
    ok = (first < active) & (s_rank[np.minimum(first, active - 1)] == distinct)
    if not ok.all():
        missing = a_sorted[heads][~ok][0]
        raise ValueError(f"lookup failure: input {FR.decode(missing)} not in table")

    consumed = np.zeros(active, bool)
    consumed[first] = True
    s_prime = np.empty_like(a_sorted)
    s_prime[heads] = a_sorted[heads]
    s_prime[~heads] = s_sorted[~consumed]

    tail_a = blinds.words(n - active)
    tail_s = blinds.words(n - active)
    return np.concatenate([a_sorted, tail_a]), np.concatenate([s_prime, tail_s])


def _instance_words(inst: list[int], n: int) -> np.ndarray:
    arr = np.zeros((n, ff.W), np.uint32)
    if inst:
        arr[: len(inst)] = FR.encode_many(inst)
    return arr


def _h_part(protocol, cols_order: list, part_vals: torch.Tensor, domain_x: torch.Tensor,
            ch_mont: list, y: int) -> torch.Tensor:
    """One n-point part of the quotient's numerator: every constraint of
    ``protocol`` evaluated on ``part_vals`` ((columns, n, 8), in
    ``cols_order``), folded by powers of y (kernel M on the card, one
    launch; its plain version on the CPU)."""
    return quotient.h_part(protocol, cols_order, part_vals, domain_x, ch_mont, y)


def create_proof(
    params: ParamsKZG,
    pk: ProvingKey,
    instances: list[list[int]],
    witness_phases,
    *,
    seed: int | None = None,
    transcript: KeccakTranscript | PoseidonTranscript | None = None,
) -> Proof:
    """witness_phases: callable (phase, challenges: dict[Challenge, int]) ->
    {advice Column: (n, 8) uint32 Montgomery words} covering that phase's
    columns. For single-phase circuits, a plain dict {Column: array} or an
    Assignment also works.
    """
    cs = pk.vk.cs
    domain = pk.vk.domain
    k, n = domain.k, domain.n
    dev = params.device
    usable = cs.usable_rows(n)
    u_row = usable - 1
    draw = _BlindSampler(seed)
    tr = transcript or KeccakTranscript(dev)

    if isinstance(witness_phases, Assignment):
        adv = {c: witness_phases.cols[c] for c in cs.advice_columns}
        witness_phases = lambda phase, ch: {c: a for c, a in adv.items() if c.phase == phase}  # noqa: E731
    elif isinstance(witness_phases, dict):
        adv = dict(witness_phases)
        witness_phases = lambda phase, ch: {c: a for c, a in adv.items() if c.phase == phase}  # noqa: E731

    def to_dev(words: np.ndarray) -> torch.Tensor:
        return ff.to_tensor(words, dev)

    # -- 0. bind statement ----------------------------------------------
    tr.common_scalar(k)
    for inst in instances:
        for v in inst:
            tr.common_scalar(v)
    for c in pk.vk.fixed_commitments + pk.vk.sigma_commitments:
        tr.common_point(c)

    # -- 1. advice commitments per phase, interleaved with challenges ----
    advice_lagrange: dict = {}
    advice_coeff: dict = {}
    advice_comm: dict = {}
    challenge_vals: dict = {}

    for phase in range(cs.num_phases):
        ch_by_obj = {c: challenge_vals.get(c.index) for c in cs.challenges}
        new_cols = witness_phases(phase, ch_by_obj)
        cols = [c for c in cs.advice_columns if c.phase == phase]
        for c in cols:
            arr = np.array(new_cols[c], dtype=np.uint32)
            arr[usable:] = draw.words(n - usable)
            advice_lagrange[c] = arr
        if cols:
            coeffs = nttmod.intt(to_dev(np.stack([advice_lagrange[c] for c in cols])), k)
            for c, coeff in zip(cols, coeffs):
                advice_coeff[c] = coeff
                advice_comm[c] = _commit(params, coeff)
                tr.common_point(advice_comm[c])
        for ch in cs.challenges:
            if ch.phase == phase + 1:
                challenge_vals[ch.index] = tr.challenge()

    challenges_int = [challenge_vals.get(i, 0) for i in range(len(cs.challenges))]
    ch_mont = [FR.const(v, dev) for v in challenges_int]

    # -- 2. theta; lookup permuted columns -------------------------------
    theta = tr.challenge()
    lagrange = dict(pk.fixed_lagrange)
    lagrange.update(advice_lagrange)
    for c, inst in zip(cs.instance_columns, instances):
        lagrange[c] = _instance_words(inst, n)
    # only the columns the lookups and the permutation read go to the device
    needed = set(cs.permutation_columns)
    for lk in cs.lookups:
        for e in lk.inputs + lk.tables:
            needed |= {col for col, _ in e.queries()}
    base_cols = {c: to_dev(lagrange[c]) for c in needed}
    base_ctx = EvalContext(base_cols, ch_mont, dev)

    def compress_vals(exprs):
        acc = None
        th = FR.const(theta, dev)
        for e in exprs:
            v = e.evaluate(base_ctx).expand(n, ff.W)
            acc = v if acc is None else ff.add(FR, ff.mont_mul(FR, acc, th), v)
        return acc

    lookup_data = []
    for lk in cs.lookups:
        a_vals = compress_vals(lk.inputs)
        s_vals = compress_vals(lk.tables)
        ap, sp = _permute_lookup(
            ff.to_words(a_vals), ff.to_words(s_vals), u_row, n, draw
        )
        lookup_data.append({"a": a_vals, "s": s_vals, "ap": to_dev(ap), "sp": to_dev(sp)})

    lookup_permuted = []
    for ld in lookup_data:
        ld["ap_coeff"] = nttmod.intt(ld["ap"], k)
        ld["sp_coeff"] = nttmod.intt(ld["sp"], k)
        ca = _commit(params, ld["ap_coeff"])
        cb = _commit(params, ld["sp_coeff"])
        lookup_permuted.append((ca, cb))
        tr.common_point(ca)
        tr.common_point(cb)

    # -- 3. beta, gamma; grand products ----------------------------------
    beta = tr.challenge()
    gamma = tr.challenge()
    beta_m = FR.const(beta, dev)
    gamma_m = FR.const(gamma, dev)
    one_m = FR.mont_one(dev)
    active_mask = torch.zeros(n, 1, dtype=torch.bool, device=dev)
    active_mask[:u_row] = True

    protocol = build_protocol(cs, n, theta, beta, gamma)
    chunk_len = cs.permutation_chunk_len()

    def blind_tail(z: torch.Tensor) -> torch.Tensor:
        z = z.clone()
        z[usable:] = to_dev(draw.words(n - usable))
        return z

    perm_z_arrays = []
    last_tail = None
    for ci, cols in enumerate(protocol.perm_chunks):
        num = None
        den = None
        for j, col in enumerate(cols):
            jg = ci * chunk_len + j
            val = base_cols[col]
            sig = to_dev(pk.sigma_lagrange[jg])
            idb = pk.identity_base[jg]
            # z(wX) * prod(col + b*sigma + g) = z(X) * prod(col + b*dX + g)
            f_num = ff.add(FR, ff.add(FR, val, ff.mont_mul(FR, beta_m, idb)), gamma_m)
            f_den = ff.add(FR, ff.add(FR, val, ff.mont_mul(FR, beta_m, sig)), gamma_m)
            num = f_num if num is None else ff.mont_mul(FR, num, f_num)
            den = f_den if den is None else ff.mont_mul(FR, den, f_den)
        factors = ff.mont_mul(FR, num, ff.inv(FR, den))
        factors = torch.where(active_mask, factors, one_m)
        z = prefix_product(FR, factors)
        if ci > 0:  # chain: multiply by the previous chunk's final value
            z = ff.mont_mul(FR, z, last_tail)
        last_tail = z[u_row]
        perm_z_arrays.append(blind_tail(z))

    lookup_z_arrays = []
    for ld in lookup_data:
        num = ff.mont_mul(FR, ff.add(FR, ld["a"], beta_m), ff.add(FR, ld["s"], gamma_m))
        den = ff.mont_mul(FR, ff.add(FR, ld["ap"], beta_m), ff.add(FR, ld["sp"], gamma_m))
        factors = ff.mont_mul(FR, num, ff.inv(FR, den))
        factors = torch.where(active_mask, factors, one_m)
        lookup_z_arrays.append(blind_tail(prefix_product(FR, factors)))

    perm_z_comm, perm_z_coeff = [], []
    for z in perm_z_arrays:
        coeff = nttmod.intt(z, k)
        perm_z_coeff.append(coeff)
        c = _commit(params, coeff)
        perm_z_comm.append(c)
        tr.common_point(c)
    lookup_z_comm, lookup_z_coeff = [], []
    for z in lookup_z_arrays:
        coeff = nttmod.intt(z, k)
        lookup_z_coeff.append(coeff)
        c = _commit(params, coeff)
        lookup_z_comm.append(c)
        tr.common_point(c)

    # -- 4. vanishing: random poly, y, quotient --------------------------
    random_coeff = to_dev(draw.words(n))
    random_comm = _commit(params, random_coeff)
    tr.common_point(random_comm)
    y = tr.challenge()

    # The extended coset splits into P = extended_n / n interleaved parts
    # (part j = points g*W^j*<w_n>, full index i = m*P + j): a unit
    # rotation shifts the full index by P, a unit row shift inside the
    # part, so every constraint evaluates per part on n-row tensors.
    P = domain.extended_n // n
    coeff_map = dict(pk.fixed_coeff)
    coeff_map.update(advice_coeff)
    for c, inst in zip(cs.instance_columns, instances):
        coeff_map[c] = nttmod.intt(to_dev(_instance_words(inst, n)), k)
    for i, sig_col in enumerate(protocol.sigma_cols):
        coeff_map[sig_col] = pk.sigma_coeff[i]
    l0c, llastc, lblindc = protocol.virtual_cols
    coeff_map[l0c] = pk.l0_coeff
    coeff_map[llastc] = pk.llast_coeff
    coeff_map[lblindc] = pk.lblind_coeff
    aux_coeffs = {}
    for i, ld in enumerate(lookup_data):
        aux_coeffs[aux(f"lookup_a_perm{i}")] = ld["ap_coeff"]
        aux_coeffs[aux(f"lookup_s_perm{i}")] = ld["sp_coeff"]
        aux_coeffs[aux(f"lookup_z{i}")] = lookup_z_coeff[i]
    for ci in range(len(protocol.perm_chunks)):
        aux_coeffs[aux(f"perm_z{ci}")] = perm_z_coeff[ci]
    coeff_map.update(aux_coeffs)

    cols_order = list(coeff_map)
    big = torch.stack([coeff_map[c] for c in cols_order])
    wn_pows = nttmod.power_table(domain.omega, n, dev)

    h_parts = []
    for j in range(P):
        shift = domain.g_coset * pow(domain.extended_omega, j, FR_MOD) % FR_MOD
        part_vals = nttmod.coset_ntt(big, shift)  # the shift fused into kernel B's loads
        domain_x = ff.mont_mul(FR, wn_pows, FR.const(shift, dev))
        h_parts.append(_h_part(protocol, cols_order, part_vals, domain_x, ch_mont, y))
        del part_vals
    del big
    # interleave: full[m*P + j] = parts[j][m]
    h_ext = torch.stack(h_parts, dim=1).reshape(domain.extended_n, ff.W)
    del h_parts
    h_ext = domain.divide_by_vanishing_poly(h_ext)
    h_coeff_full = domain.extended_to_coeff(h_ext)
    del h_ext
    # deg(h) <= d(n-1) - n < (d-1)n for gate degree d, so exactly d-1
    # n-chunks carry coefficients (halo2's quotient_poly_degree)
    num_pieces = max(cs.gate_degree() - 1, 1)
    if num_pieces > P:
        raise ValueError("extended domain too small for the quotient")
    if bool((h_coeff_full[num_pieces * n:] != 0).any()):
        raise ValueError("quotient tail pieces must be zero (constraints not satisfied)")
    h_pieces = [h_coeff_full[i * n : (i + 1) * n] for i in range(num_pieces)]
    h_comms = []
    for hp in h_pieces:
        c = _commit(params, hp)
        h_comms.append(c)
        tr.common_point(c)

    x = tr.challenge()

    # -- 5. evaluations ---------------------------------------------------
    def coeff_of(col):
        if col.kind == "fixed":
            return pk.fixed_coeff[col]
        if col.kind == "advice":
            return advice_coeff[col]
        if col.kind == "aux":
            if str(col.index).startswith("sigma"):
                return pk.sigma_coeff[int(str(col.index)[5:])]
            return aux_coeffs[col]
        raise KeyError(col)

    omega = domain.omega
    by_rot: dict[int, list] = {}
    for col, rot in protocol.queries:
        by_rot.setdefault(rot, []).append(col)
    evals_map = {}
    for rot, cols_r in by_rot.items():
        pt = pow(omega, rot % n, FR_MOD) * x % FR_MOD
        vals = eval_polys_at(torch.stack([coeff_of(c) for c in cols_r]), pt)
        for c, v in zip(cols_r, vals):
            evals_map[(c, rot)] = v
    random_eval = eval_polys_at(random_coeff[None], x)[0]

    evals_list = [evals_map[q] for q in protocol.queries] + [random_eval]
    for v in evals_list:
        tr.common_scalar(v)

    # -- 6. SHPLONK multiopen ---------------------------------------------
    # collapsed h polynomial: sum x^{n i} h_i
    xn = pow(x, n, FR_MOD)
    weights = [pow(xn, i, FR_MOD) for i in range(num_pieces)]
    w_m = ff.to_tensor(FR.encode_many(weights), dev)[:, None, :]
    hc = ff.sum_rows(FR, ff.mont_mul(FR, torch.stack(h_pieces), w_m), dim=0)
    # actual collapsed-h eval; the verifier recomputes the EXPECTED value
    # from the gate identity -- if they differ the shplonk check fails.
    h_eval = eval_polys_at(hc[None], x)[0]

    sh_queries = []  # (label, coeff tensor, point, eval)
    for (col, rot) in protocol.queries:
        pt = pow(omega, rot % n, FR_MOD) * x % FR_MOD
        sh_queries.append((f"{col.kind}:{col.index}", coeff_of(col), pt, evals_map[(col, rot)]))
    sh_queries.append(("random", random_coeff, x, random_eval))
    sh_queries.append(("h_collapsed", hc, x, h_eval))

    sh_h, sh_w = shplonk.open_many(params, domain, sh_queries, tr)

    return Proof(
        advice_commitments=[advice_comm[c] for c in cs.advice_columns],
        lookup_permuted=lookup_permuted,
        perm_z_commitments=perm_z_comm,
        lookup_z_commitments=lookup_z_comm,
        random_commitment=random_comm,
        h_commitments=h_comms,
        evals=evals_list,
        shplonk_h=sh_h,
        shplonk_w=sh_w,
    )
