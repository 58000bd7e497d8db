"""Device-mesh sharding for the proving hot paths, over ``torch.distributed``.

Port of ``zkevm_tpu/parallel/mesh.py``. The reference shards over a 1-D
``chips`` mesh of JAX devices with ``shard_map`` and XLA collectives; here a
mesh is the processes of one ``torch.distributed`` process group, one per
device: NCCL between GPUs, gloo between CPU processes (as the tests run it).
Every rank holds the whole input (the reference's global array), computes
its shard with the port's kernels, and the collectives move what the
reference's move:

- MSMs (``sharded_msm``, ``sharded_msm_t_scan``, ``sharded_msm_t``,
  ``MeshMSM``): the point axis in equal shards over the ranks; each rank
  reduces its shard to one Jacobian point (kernel C's per-lane scalar
  multiplication and a halving tree of additions, or kernel G's Pippenger
  MSM), the partials ride one all_gather of 3 x 8 words per rank, and every
  rank folds them in rank order with C's addition.
- ``sharded_ntt_batch``: kernel B on the rank's polynomials, no
  communication before the result is gathered.
- ``sharded_ntt_t``: one four-step transform (kernel I) whose transpose
  is an all_to_all: the column pass on the rank's columns, the all_to_all of
  row blocks, the row pass on the rank's rows, then a gather and the
  transpose.

Every function returns on every rank the whole result, what the reference's
global array holds; where the reference leaves it sharded
(``sharded_ntt_batch``), the port gathers it. Collectives pass 2-D tensors
concatenated along dim 0, the shapes both gloo and NCCL accept. The module
counts the collectives it issues (``collective_counts``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from zkevm_tpu_torch.device import resolve_device
from zkevm_tpu_torch.ec import group, msm as msmmod, pippenger as pip
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.poly import ntt as nttmod

_collectives = {"all_gather": 0, "all_to_all": 0}


def reset_collectives() -> None:
    for name in _collectives:
        _collectives[name] = 0


def collective_counts() -> dict[str, int]:
    return dict(_collectives)


class Mesh:
    """The processes of one process group as a 1-D ``chips`` mesh: the
    group, its size, this process's rank and the device it computes on."""

    def __init__(self, group, world: int, rank: int, device):
        self.group = group
        self.world = world
        self.rank = rank
        self.device = torch.device(device)

    @property
    def shape(self) -> dict:
        return {"chips": self.world}

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's equal share of dim 0 (a view)."""
        if x.shape[0] % self.world:
            raise ValueError(f"{x.shape[0]} rows do not split over {self.world} devices")
        m = x.shape[0] // self.world
        return x[self.rank * m : (self.rank + 1) * m]


def default_mesh(n_devices: int | None = None, *, device=None) -> Mesh:
    """The mesh of the initialised default process group (torchrun starts
    one process per device; a world of one is a process group of size 1).
    ``n_devices`` must equal the world size. The device defaults to
    ``cuda:<local rank>``; the CPU only when asked (``device="cpu"``, gloo)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("default_mesh: no process group; call torch.distributed.init_process_group "
                           "first (torchrun --nproc_per_node=N starts one process per device)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"default_mesh: {n_devices} devices asked, the process group has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)) % torch.cuda.device_count())
    return Mesh(dist.group.WORLD, world, rank, dev)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """(m, ...) on every rank -> (world * m, ...), rank by rank."""
    flat = t.contiguous().reshape(-1, t.shape[-1])
    out = torch.empty(mesh.world * flat.shape[0], flat.shape[1], dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, flat, group=mesh.group)
    _collectives["all_gather"] += 1
    return out.reshape(mesh.world * t.shape[0], *t.shape[1:])


def _all_to_all(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Block i of dim 0 goes to rank i; block j of the result came from rank j."""
    flat = t.contiguous().reshape(-1, t.shape[-1])
    out = torch.empty_like(flat)
    dist.all_to_all_single(out, flat, group=mesh.group)
    _collectives["all_to_all"] += 1
    return out.reshape(t.shape)


def _gather_fold(mesh: Mesh, part: torch.Tensor, add) -> torch.Tensor:
    """Every rank's (3, 8) partial -> their sum in rank order, on every rank."""
    parts = _all_gather(mesh, part.reshape(3, ff.W)).reshape(mesh.world, 3, ff.W)
    acc = parts[0]
    for i in range(1, mesh.world):
        acc = add(acc, parts[i])
    return acc


# ---------------------------------------------------------------------------
# Point-sharded MSMs
# ---------------------------------------------------------------------------

def _msm_shard(mesh: Mesh, points: torch.Tensor, scalars: torch.Tensor):
    if points.dim() != 3 or points.shape[1:] != (3, ff.W) or points.shape[0] == 0:
        raise ValueError(f"sharded msm: points must be (N, 3, 8), got {tuple(points.shape)}")
    if scalars.shape != (points.shape[0], ff.W):
        raise ValueError(f"sharded msm: expected scalars {(points.shape[0], ff.W)}, got {tuple(scalars.shape)}")
    return mesh.shard(points), mesh.shard(scalars)


def _tree_sum(p: torch.Tensor) -> torch.Tensor:
    """Sum of (m, 3, 8) points by a halving tree of C's additions, padded
    with the identity to a power of two."""
    m = p.shape[0]
    size = 1 << (m - 1).bit_length()
    if size != m:
        p = torch.cat([p, group.identity((size - m,), p.device)])
    while p.shape[0] > 1:
        h = p.shape[0] // 2
        p = group.add(p[:h], p[h:])
    return p[0]


def _low_bits(scalars: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Scalars cut to their low num_bits bits (the bits a scan over
    num_bits reads)."""
    if not 1 <= num_bits <= 256:
        raise ValueError("num_bits must be in [1, 256]")
    if num_bits == 256:
        return scalars
    mask = ff.to_tensor(ff.words_from_ints([(1 << num_bits) - 1])[0], scalars.device)
    return scalars & mask


def sharded_msm(mesh: Mesh, points: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """MSM with the point axis sharded over the mesh.

    points: (N, 3, 8) Jacobian, N divisible by the mesh size; scalars (N, 8)
    standard-form words. Each rank multiplies its shard lane by lane (C) and
    sums it by a halving tree; the partials are gathered and folded. Returns
    one (3, 8) point on every rank."""
    return _scan_msm(mesh, points, scalars, 256)


def _scan_msm(mesh: Mesh, points, scalars, num_bits: int, table=None) -> torch.Tensor:
    pts, sc = _msm_shard(mesh, points, scalars)
    sc = _low_bits(sc, num_bits)
    if table is not None and pts.device.type == "cpu":
        part = msmmod.plain_msm(pts, sc, table)  # the same sum from the shard's doubling table
    else:
        part = _tree_sum(group.scalar_mul(pts, sc))
    return _gather_fold(mesh, part, group.add)


def sharded_msm_t_scan(mesh: Mesh, points: torch.Tensor, scalars: torch.Tensor, *,
                       num_bits: int = 256) -> torch.Tensor:
    """Point-sharded double-and-add MSM over the low ``num_bits`` bits of
    each scalar: C's per-lane double-and-add on the rank's shard, its sum,
    then the gather and fold. Same arguments and result as sharded_msm."""
    return _scan_msm(mesh, points, scalars, num_bits)


SUBLANES = 128  # the reference's sharded_msm_t lanes


def _sharded_msm_t(mesh, points, scalars, c, num_bits, sublanes, msm, add) -> torch.Tensor:
    pts, sc = _msm_shard(mesh, points, scalars)
    return _gather_fold(mesh, msm(pts, sc, c=c, num_bits=num_bits, sublanes=sublanes), add)


def sharded_msm_t(mesh: Mesh, points: torch.Tensor, scalars: torch.Tensor, *, c: int = 4,
                  num_bits: int = 256, sublanes: int = SUBLANES) -> torch.Tensor:
    """Point-sharded Pippenger MSM (the commit hot path): each rank runs
    kernel G (``ec/pippenger.py`` ``msm``, c-bit windows, Lw = sublanes) on
    its shard; the partials ride the gather and fold. Returns one (3, 8)
    point on every rank."""
    return _sharded_msm_t(mesh, points, scalars, c, num_bits, sublanes, pip.msm, group.add)


class MeshMSM:
    """Mesh-sharded commit engine with ``ParamsKZG.committer``'s interface:
    (N, 8) standard-form scalars -> one (3, 8) point.

    ``ParamsKZG.use_mesh`` installs it, so that every commitment of keygen
    and create_proof runs point-sharded over the mesh. scan=True goes
    through sharded_msm_t_scan (C's double-and-add), scan=False through
    sharded_msm_t at window c (kernel G), over the affine copy of its shard
    that G's engine keeps (``group.to_affine``, made once here). On the CPU
    the scan engine keeps the doubling table of its shard, as
    ``ec/msm.py``'s MSM keeps its bases', and sums with C's plain MSM: the
    plain per-lane double-and-add would double every base 255 times on each
    call."""

    def __init__(self, mesh: Mesh, points: torch.Tensor, *, scan: bool = False, c: int = 16,
                 num_bits: int = 256):
        if points.dim() != 3 or points.shape[1:] != (3, ff.W):
            raise ValueError(f"MeshMSM bases must be (N, 3, 8), got {tuple(points.shape)}")
        self.mesh = mesh
        self.points = points
        self.scan = scan
        self.c = c
        self.num_bits = num_bits
        self.n = points.shape[0]
        self._table = None
        self._affine = None if scan else group.to_affine(mesh.shard(points))

    def __call__(self, scalars: torch.Tensor) -> torch.Tensor:
        if scalars.shape != (self.n, ff.W):
            raise ValueError(f"MeshMSM: expected scalars ({self.n}, 8), got {tuple(scalars.shape)}")
        if self.scan:
            if self._table is None and self.points.device.type == "cpu":
                self._table = group.doubling_table(self.mesh.shard(self.points))
            return _scan_msm(self.mesh, self.points, scalars, self.num_bits, self._table)
        part = pip.msm_affine(self._affine, self.mesh.shard(scalars), c=self.c, num_bits=self.num_bits,
                              sublanes=SUBLANES)
        return _gather_fold(self.mesh, part, group.add)


# ---------------------------------------------------------------------------
# Sharded NTTs
# ---------------------------------------------------------------------------

def sharded_ntt_batch(mesh: Mesh, polys: torch.Tensor, k: int) -> torch.Tensor:
    """NTT of a (B, n, 8) stack with B sharded over the mesh (B divisible by
    the mesh size): kernel B on the rank's polynomials, no communication;
    then the port gathers the (B, n, 8) result onto every rank, where the
    reference leaves it sharded."""
    if polys.dim() != 3 or polys.shape[2] != ff.W:
        raise ValueError(f"sharded_ntt_batch: expected (B, n, 8), got {tuple(polys.shape)}")
    return _all_gather(mesh, nttmod.ntt(mesh.shard(polys), k))


def _sharded_ntt_t(mesh, a, k, inverse, cols, rows, transpose) -> torch.Tensor:
    n = 1 << k
    if k < 1 or a.shape != (n, ff.W):
        raise ValueError(f"sharded_ntt_t: expected ({n}, 8) with k >= 1, got {tuple(a.shape)}")
    k1, k2 = nttmod.fourstep_split(k)
    n1, n2, chips = 1 << k1, 1 << k2, mesh.world
    if n1 % chips or n2 % chips:
        raise ValueError(f"sharded_ntt_t: a ({n1}, {n2}) view does not split over {chips} devices")
    w = n2 // chips
    c0 = mesh.rank * w
    b = cols(a.reshape(1, n1, n2, ff.W)[:, :, c0 : c0 + w], k, c0=c0, inverse=inverse)  # (1, n1, w, 8)
    b = _all_to_all(mesh, b.reshape(n1, w, ff.W))  # block j: rank j's columns of this rank's rows
    d = rows(b, k, k2, parts=chips, inverse=inverse)  # (n1 / chips, n2, 8)
    d = _all_gather(mesh, d)  # (n1, n2, 8)
    return transpose(d.reshape(1, n1, n2, ff.W)).reshape(n, ff.W)


def sharded_ntt_t(mesh: Mesh, a: torch.Tensor, k: int, inverse: bool = False) -> torch.Tensor:
    """One four-step NTT of (2^k, 8) Montgomery words with its transpose as
    an all_to_all (the reference's ``sharded_ntt_t``; its ``unroll`` compile
    knob has no counterpart here).

    The (n1, n2) view is column-sharded: each rank runs kernel I's column
    pass (full-height size-n1 sub-NTTs and the twiddle) on its n2/C columns,
    one all_to_all leaves it n1/C full rows, the row pass runs the size-n2
    sub-NTTs on them (times 1/n for an inverse), and the rows are gathered
    and transposed. Returns (2^k, 8) in natural order on every rank."""
    return _sharded_ntt_t(mesh, a, k, inverse, nttmod.ntt4_cols, nttmod.ntt4_rows, nttmod.ntt4_transpose)


def _plain_sharded_msm_t(mesh, points, scalars, *, c=4, num_bits=256, sublanes=SUBLANES):
    return _sharded_msm_t(mesh, points, scalars, c, num_bits, sublanes, pip.PLAIN["msm"], group.PLAIN["add"])


def _plain_sharded_ntt_t(mesh, a, k, inverse=False):
    p = nttmod.PLAIN
    return _sharded_ntt_t(mesh, a, k, inverse, p["ntt4_cols"], p["ntt4_rows"], p["ntt4_transpose"])


# the same collectives around the local kernels' plain versions, on any device
PLAIN = {"sharded_msm_t": _plain_sharded_msm_t, "sharded_ntt_t": _plain_sharded_ntt_t}
