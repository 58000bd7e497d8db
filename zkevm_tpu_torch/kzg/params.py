"""KZG commitment parameters (SRS), commitments and the single-point opening.

Port of ``zkevm_tpu/kzg/params.py`` (``ParamsKZG.unsafe_setup``,
``commit``, ``commit_lagrange``, ``open_single``, ``verify_single``). The
SRS is a device batch of Jacobian points ``[tau^i] G1`` (``(n, 3, 8)``);
commitments run the params' commit engine on standard-form scalars: kernel
C's MSM (``ec/msm.py``) unless the constructor is given another, as
``unsafe_setup`` does at k > 10 when asked for another engine (by name, as
the reference reads ``ZKEVM_TPU_MSM``: "l13" the lazy-13 MSM of
``ec/msm13.py``, "ps" C's, "pippenger" the Pippenger MSM of
``ec/pippenger.py``), as ``kzg/srs.py`` gives a loaded file the Pippenger
engine at k > 10, or as ``use_mesh`` installs the mesh-sharded engine
(``parallel/mesh.py``). ``open_single`` computes its value and quotient with kernel H
(``csrc/kzg.cu``). Pairing-side values (G2 points) are host ints, used only
by the verifiers.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass, field

import torch

from zkevm_tpu_torch import kernels
from zkevm_tpu_torch.device import resolve_device
from zkevm_tpu_torch.ec import goldens as g1g, group, msm13, pairing as pr, pippenger as pip
from zkevm_tpu_torch.ec.msm import MSM
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FR_MOD, fr_root_of_unity
from zkevm_tpu_torch.parallel import mesh as meshmod
from zkevm_tpu_torch.poly import ntt as nttmod

OPEN_THREADS = 256  # csrc/kzg.cu's block size
ENGINE_MIN_K = 11  # unsafe_setup picks its engine by name above k = 10, as the reference
DEFAULT_ENGINE = "ps"  # C's MSM: the port's engine since its first slice
ENGINES = ("l13", "ps", "pippenger")
L13_C, L13_LANES, L13_WGROUP = 16, 4096, 8  # the reference's Msm13 geometry (unsafe_setup, bench.py)
OPEN_MAX_BLOCKS = 1024  # partial sums the one-block finishing pass adds


@dataclass
class ParamsKZG:
    k: int
    g1_powers: torch.Tensor  # (n, 3, 8) [tau^i] G1
    g2: tuple  # host affine Fq2 pair
    s_g2: tuple  # [tau] G2
    committer: object = field(default=None, repr=False)  # scalars (n, 8) -> (3, 8); MSM by default

    def __post_init__(self):
        if self.g1_powers.shape != (1 << self.k, 3, ff.W):
            raise ValueError(f"g1_powers must be ({1 << self.k}, 3, 8)")
        if self.committer is None:
            self.committer = MSM(self.g1_powers)

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def device(self) -> torch.device:
        return self.g1_powers.device

    @classmethod
    def unsafe_setup(cls, k: int, tau: int = 0xDEAD_BEEF_CAFE, *, device=None, engine: str | None = None
                     ) -> "ParamsKZG":
        """Test-only SRS from a known tau: the powers of tau by a prefix
        product, then one per-lane scalar multiplication of the generator
        (the reference's _srs_gen).

        The commit engine at k > 10 is ``engine``, else the environment's
        ``ZKEVM_TPU_MSM``, else "ps", with the reference's names: "l13"
        ``msm13.Msm13`` (c = 16, lanes 4096, window groups of 8), "ps" C's
        MSM, "pippenger" G's Pippenger MSM; another name raises ValueError.
        At k <= 10 it is C's MSM whatever is asked."""
        name = engine if engine is not None else os.environ.get("ZKEVM_TPU_MSM", DEFAULT_ENGINE)
        if name not in ENGINES:
            raise ValueError(f"unsafe_setup: unknown commit engine {name!r} (one of {ENGINES})")
        device = resolve_device(device)
        n = 1 << k
        tau %= FR_MOD
        pows = ff.prefix_product(FR, FR.const(tau, device).expand(n, ff.W))  # [1, tau, ...]
        gen = group.from_affine_ints([g1g.G1_GEN], device)[0]
        g1_powers = group.scalar_mul(gen, ff.from_mont(FR, pows))
        s_g2 = pr.g2_scalar_mul(pr.G2_GEN, tau)
        committer = None
        if k >= ENGINE_MIN_K:
            if name == "l13":
                committer = msm13.Msm13(g1_powers, c=L13_C, lanes=L13_LANES, wgroup=L13_WGROUP)
            elif name == "pippenger":
                committer = pip.PippengerMSM(g1_powers)
        return cls(k=k, g1_powers=g1_powers, g2=pr.G2_GEN, s_g2=s_g2, committer=committer)

    def use_mesh(self, mesh=None, *, scan: bool = False) -> "ParamsKZG":
        """Shard the commit engine over a device mesh (in place).

        Replaces the engine with ``parallel.mesh.MeshMSM`` over the SRS:
        every ``commit`` (so every commitment inside keygen and create_proof)
        runs point-sharded over the mesh with an all_gather of the partial
        sums. mesh=None builds ``default_mesh()`` on the params' device (a
        process group must be initialised). Raises ValueError when n does not
        split over the mesh (the reference asserts)."""
        if mesh is None:
            mesh = meshmod.default_mesh(device=self.device)
        chips = mesh.shape["chips"]
        if self.n % chips:
            raise ValueError(f"use_mesh: {self.n} SRS points do not split over {chips} devices")
        self.committer = meshmod.MeshMSM(mesh, self.g1_powers, scan=scan)
        return self

    def commit(self, coeffs_mont: torch.Tensor) -> torch.Tensor:
        """Commit to a coefficient-form polynomial ((n, 8) Montgomery)."""
        return self.committer(ff.from_mont(FR, coeffs_mont))

    def commit_lagrange(self, evals_mont: torch.Tensor) -> torch.Tensor:
        return self.commit(nttmod.intt(evals_mont, self.k))


# ---------------------------------------------------------------------------
# Single-point opening (kernel H and its plain version)
# ---------------------------------------------------------------------------

def _plain_open_quotient(f, xs, d, scale: int):
    """f(z) = scale * sum_i f_i x_i d_i and q_i = (f_i - f(z)) d_i, by the
    plain field ops (all Montgomery; ``scale`` an int)."""
    mul = ff.PLAIN["mul"]
    terms = mul(FR, mul(FR, f, xs), d)
    while terms.shape[0] > 1:
        h = (terms.shape[0] + 1) // 2
        tail = terms[h:]
        if tail.shape[0] < h:
            tail = torch.cat([tail, torch.zeros_like(terms[:1])])
        terms = ff.PLAIN["add"](FR, terms[:h], tail)
    fz = mul(FR, terms[0], FR.const(scale, f.device))
    return fz, mul(FR, ff.PLAIN["sub"](FR, f, fz), d)


def _launch_open_quotient(f, xs, d, scale: int):
    for name, t in (("evals", f), ("domain points", xs), ("inverses", d)):
        kernels.check_cuda_tensor(f"open_single {name}", t, torch.int32, ff.W)
    n = f.shape[0]
    blocks = min(OPEN_MAX_BLOCKS, -(-n // OPEN_THREADS))
    partials = torch.empty(blocks, ff.W, dtype=torch.int32, device=f.device)
    kernels.launch("kzg_open", "kzg", "zk_kzg_open_terms", partials.data_ptr(), f.data_ptr(),
                   xs.data_ptr(), d.data_ptr(), n, blocks)
    fz = torch.empty(ff.W, dtype=torch.int32, device=f.device)
    words = (ctypes.c_uint32 * 8)(*[int(w) for w in FR.encode(scale)])
    kernels.launch("kzg_open", "kzg", "zk_kzg_open_finish", fz.data_ptr(), partials.data_ptr(), blocks,
                   ctypes.addressof(words))
    q = torch.empty_like(f)
    kernels.launch("kzg_open", "kzg", "zk_kzg_open_quotient", q.data_ptr(), f.data_ptr(), fz.data_ptr(),
                   d.data_ptr(), n)
    return fz, q


def open_quotient(f: torch.Tensor, xs: torch.Tensor, d: torch.Tensor, scale: int):
    """(n, 8) Montgomery evaluations f, domain points xs and inverses d ->
    (f(z), q): f(z) = scale * sum_i f_i xs_i d_i, q_i = (f_i - f(z)) d_i."""
    if not (f.shape == xs.shape == d.shape) or f.dim() != 2 or f.shape[1] != ff.W or f.shape[0] == 0:
        raise ValueError(f"open_quotient: expected three equal (n, 8) tensors, got "
                         f"{tuple(f.shape)}, {tuple(xs.shape)}, {tuple(d.shape)}")
    if {f.device.type, xs.device.type, d.device.type} == {"cpu"}:
        return _plain_open_quotient(f, xs, d, scale)
    return _launch_open_quotient(f.contiguous(), xs.contiguous(), d.contiguous(), scale)


def open_single(params: ParamsKZG, evals_mont: torch.Tensor, z: int):
    """KZG opening at a point z outside the 2^k domain of a polynomial in
    evaluation form ((n, 8) Montgomery).

    Returns (value int, proof point (3, 8)): f(z) by barycentric
    interpolation, f(z) = (z^n - 1)/n * sum_i f_i w^i / (z - w^i), and the
    commitment to the quotient q(w^i) = (f(w^i) - f(z)) / (w^i - z)."""
    n, k = params.n, params.k
    if evals_mont.shape != (n, ff.W):
        raise ValueError(f"open_single: expected evaluations ({n}, 8), got {tuple(evals_mont.shape)}")
    dev = evals_mont.device
    xs = nttmod.power_table(fr_root_of_unity(k), n, dev)  # w^i
    d = ff.inv(FR, ff.sub(FR, xs, FR.const(z, dev)))  # 1 / (w^i - z)
    zn1 = (pow(z, n, FR_MOD) - 1) % FR_MOD
    factor = zn1 * pow(n, FR_MOD - 2, FR_MOD) % FR_MOD
    fz, q = open_quotient(evals_mont, xs, d, (-factor) % FR_MOD)  # 1/(z - w^i) = -d_i
    return FR.decode(fz), params.commit_lagrange(q)


def verify_single(params: ParamsKZG, commitment: torch.Tensor, z: int, value: int,
                  proof: torch.Tensor) -> bool:
    """e(W, [tau - z]_2) == e(C - [v]_1, H) check via the golden pairing."""
    c_aff = group.to_affine_ints(commitment)[0]
    w_aff = group.to_affine_ints(proof)[0]
    # C - v*G1
    v_g1 = g1g.scalar_mul(g1g.G1_GEN, value)
    lhs = g1g.add(c_aff, g1g.neg(v_g1))
    # e(W, s_g2 - z*g2) * e(-(C - vG), g2) == 1
    z_g2 = pr.g2_scalar_mul(pr.G2_GEN, z)
    s_minus_z = pr.g2_add(params.s_g2, pr.g2_neg(z_g2))
    return pr.pairing_check([(w_aff, s_minus_z), (g1g.neg(lhs), pr.G2_GEN)])


PLAIN = {"open_quotient": _plain_open_quotient}
