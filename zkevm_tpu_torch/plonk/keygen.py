"""Key generation: proving/verifying keys for the PLONKish runtime.

Port of ``zkevm_tpu/plonk/keygen.py``: commitments to the fixed columns,
the permutation argument's sigma polynomials from the recorded copy
constraints, and the Lagrange helpers l_0, l_last, l_blind, all in
coefficient form on the params' device. The reference also keeps every
fixed and sigma column evaluated on the extended coset; its prover never
reads them, and at k=20 they would take ~29 GB of device memory, so the
port does not build them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from zkevm_tpu_torch.ec import group
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FR_GENERATOR, FR_MOD, FR_TWO_ADICITY, fr_root_of_unity
from zkevm_tpu_torch.kzg.params import ParamsKZG
from zkevm_tpu_torch.plonk.assign import Assignment
from zkevm_tpu_torch.plonk.cs import ConstraintSystem
from zkevm_tpu_torch.poly import ntt as nttmod
from zkevm_tpu_torch.poly.domain import Domain

# delta: generator of the odd-order subgroup (t = (r-1)/2^S), so the cosets
# delta^j * H are pairwise disjoint -- halo2curves Fr::DELTA equivalent.
DELTA = pow(FR_GENERATOR, 1 << FR_TWO_ADICITY, FR_MOD)


@dataclass
class VerifyingKey:
    cs: ConstraintSystem
    domain: Domain
    fixed_commitments: list  # affine int pairs
    sigma_commitments: list  # affine int pairs

    @property
    def n(self) -> int:
        return self.domain.n


@dataclass
class ProvingKey:
    vk: VerifyingKey
    fixed_lagrange: dict  # Column -> (n, 8) uint32 numpy
    fixed_coeff: dict  # Column -> (n, 8) tensor
    sigma_lagrange: list  # per permutation column, (n, 8) uint32 numpy
    sigma_coeff: list
    l0_coeff: torch.Tensor
    llast_coeff: torch.Tensor
    lblind_coeff: torch.Tensor
    identity_base: list  # per permutation column j: (n, 8) tensor of delta^j * omega^i


def build_sigmas(cs: ConstraintSystem, n: int) -> list[np.ndarray]:
    """Copy constraints -> sigma columns ((n, 8) Montgomery words). Cells
    not in any cycle map to themselves."""
    perm_cols = cs.permutation_columns
    col_idx = {c: j for j, c in enumerate(perm_cols)}

    def find_rep(cell, parent):
        root = cell
        while parent.get(root, root) != root:
            root = parent[root]
        while parent.get(cell, cell) != cell:
            parent[cell], cell = root, parent[cell]
        return root

    parent: dict[int, int] = {}
    members: dict[int, list[int]] = {}
    for ca, ra, cb, rb in cs.copies:
        a = (col_idx[ca] << 40) | ra
        b = (col_idx[cb] << 40) | rb
        ra_, rb_ = find_rep(a, parent), find_rep(b, parent)
        if ra_ != rb_:
            parent[rb_] = ra_
    for ca, ra, cb, rb in cs.copies:
        for cell in ((col_idx[ca] << 40) | ra, (col_idx[cb] << 40) | rb):
            members.setdefault(find_rep(cell, parent), [])
    for ca, ra, cb, rb in cs.copies:
        for cell in ((col_idx[ca] << 40) | ra, (col_idx[cb] << 40) | rb):
            lst = members[find_rep(cell, parent)]
            if cell not in lst:
                lst.append(cell)

    sigma_cell = {}
    for cells in members.values():
        for i, cell in enumerate(cells):
            sigma_cell[cell] = cells[(i + 1) % len(cells)]

    omega = fr_root_of_unity((n - 1).bit_length())
    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * omega % FR_MOD
    deltas = [pow(DELTA, j, FR_MOD) for j in range(len(perm_cols))]

    sigmas = []
    for j in range(len(perm_cols)):
        vals = []
        for i in range(n):
            cell = (j << 40) | i
            tgt = sigma_cell.get(cell, cell)
            tj, ti = tgt >> 40, tgt & ((1 << 40) - 1)
            vals.append(deltas[tj] * omega_pows[ti] % FR_MOD)
        sigmas.append(FR.encode_many(vals))
    return sigmas


def _lagrange_one_hot(n: int, rows) -> np.ndarray:
    v = np.zeros((n, ff.W), dtype=np.uint32)
    v[list(rows)] = FR.encode(1)
    return v


def _commit_all(params: ParamsKZG, coeffs: torch.Tensor) -> list:
    return [group.to_affine_ints(params.commit(c))[0] for c in coeffs]


def keygen(params: ParamsKZG, cs: ConstraintSystem, fixed_assignment: Assignment) -> ProvingKey:
    k = params.k
    dev = params.device
    domain = Domain.new(cs.gate_degree() + 1, k)
    n = domain.n
    if fixed_assignment.n != n:
        raise ValueError(f"fixed assignment has {fixed_assignment.n} rows, params {n}")

    fixed_lagrange = {c: fixed_assignment.cols[c] for c in cs.fixed_columns}
    fixed_coeff = {}
    fixed_comm = []
    if cs.fixed_columns:
        stack = ff.to_tensor(np.stack([fixed_lagrange[c] for c in cs.fixed_columns]), dev)
        coeffs = nttmod.intt(stack, k)
        del stack
        fixed_coeff = dict(zip(cs.fixed_columns, coeffs))
        fixed_comm = _commit_all(params, coeffs)

    sigma_lagrange = build_sigmas(cs, n)
    sigma_coeff, sigma_comm = [], []
    if sigma_lagrange:
        coeffs = nttmod.intt(ff.to_tensor(np.stack(sigma_lagrange), dev), k)
        sigma_coeff = list(coeffs)
        sigma_comm = _commit_all(params, coeffs)

    usable = cs.usable_rows(n)
    u_row = usable - 1  # last active row (z reaches its final product here)
    helpers = np.stack([
        _lagrange_one_hot(n, [0]),
        _lagrange_one_hot(n, [u_row]),
        _lagrange_one_hot(n, range(usable, n)),
    ])
    l0_coeff, llast_coeff, lblind_coeff = nttmod.intt(ff.to_tensor(helpers, dev), k)

    omega_pows = nttmod.power_table(domain.omega, n, dev)
    identity_base = [ff.mont_mul(FR, omega_pows, FR.const(pow(DELTA, j, FR_MOD), dev))
                     for j in range(len(cs.permutation_columns))]

    vk = VerifyingKey(cs, domain, fixed_comm, sigma_comm)
    return ProvingKey(
        vk=vk,
        fixed_lagrange=fixed_lagrange,
        fixed_coeff=fixed_coeff,
        sigma_lagrange=sigma_lagrange,
        sigma_coeff=sigma_coeff,
        l0_coeff=l0_coeff,
        llast_coeff=llast_coeff,
        lblind_coeff=lblind_coeff,
        identity_base=identity_base,
    )
