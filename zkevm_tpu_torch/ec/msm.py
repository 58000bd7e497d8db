"""Multi-scalar multiplication (kernel C's bucket MSM and its plain version).

One engine serves every size: the reference picks a windowed fixed-base MSM
for k <= 10 (``ec/msm.py``) and the sorted prefix-sum MSM for k > 10
(``ec/psmsm.py``); only affine results must match. On CUDA it is the bucket
method of ``csrc/curve.cu`` (digits, ``torch.sort`` of (digit, index)
pairs per window, a balanced segmented bucket reduction, running sums per
bucket segment, a halving tree and Horner). On the CPU the plain version
selects from a table of 2^j * P_i and sums with a halving tree; the table
is built once per base set.
"""

from __future__ import annotations

import torch

from zkevm_tpu_torch import kernels
from zkevm_tpu_torch.ec import group
from zkevm_tpu_torch.ff import field as ff

CHUNK = 32  # sorted points one thread adds per level of the bucket reduction
SEGMENT = 64  # buckets one thread folds into sum_b b * S_b


def window_bits(n: int) -> int:
    """Window width c for n points: 16 at production sizes, smaller for
    small n so the bucket array stays proportionate."""
    return max(4, min(16, n.bit_length() - 4))


def _launch_msm(bases: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    n = bases.shape[0]
    dev = bases.device
    c = window_bits(n)
    windows = -(-256 // c)
    nb = 1 << c
    digits = torch.empty(windows, n, dtype=torch.int32, device=dev)
    kernels.launch("msm", "curve", "zk_msm_digits", digits.data_ptr(), scalars.data_ptr(), n, c,
                   windows)
    digits, perm = torch.sort(digits, dim=1, stable=True)
    perm = perm.to(torch.int32)
    buckets = torch.zeros(windows, nb, 3, ff.W, dtype=torch.int32, device=dev)
    pts, length, first = None, n, True
    while True:
        final = length <= CHUNK
        nchunks = -(-length // CHUNK)
        out_pts = torch.empty(windows, 2 * nchunks, 3, ff.W, dtype=torch.int32, device=dev)
        out_digits = torch.empty(windows, 2 * nchunks, dtype=torch.int32, device=dev)
        kernels.launch(
            "msm", "curve", "zk_msm_accumulate",
            bases.data_ptr() if first else 0,
            perm.data_ptr() if first else 0,
            0 if first else pts.data_ptr(),
            digits.data_ptr(), out_pts.data_ptr(), out_digits.data_ptr(), buckets.data_ptr(),
            length, nb, windows, CHUNK, int(final),
        )
        if final:
            break
        pts, digits, length, first = out_pts, out_digits, 2 * nchunks, False
    seg = min(nb, SEGMENT)
    sums = torch.empty(nb // seg, windows, 3, ff.W, dtype=torch.int32, device=dev)
    kernels.launch("msm", "curve", "zk_msm_bucket_reduce", sums.data_ptr(), buckets.data_ptr(),
                   windows, nb, seg)
    while sums.shape[0] > 1:
        h = sums.shape[0] // 2
        sums = group.add(sums[:h], sums[h:])
    out = torch.empty(3, ff.W, dtype=torch.int32, device=dev)
    kernels.launch("msm", "curve", "zk_g1_horner", out.data_ptr(), sums.data_ptr(), windows, c)
    return out


class MSM:
    """Commitment engine over a fixed base set (the SRS).

    bases: (N, 3, 8) Jacobian points; calls take (N, 8) standard-form
    scalars and return one (3, 8) point."""

    def __init__(self, bases: torch.Tensor):
        if bases.dim() != 3 or bases.shape[1:] != (3, ff.W):
            raise ValueError(f"MSM bases must be (N, 3, 8), got {tuple(bases.shape)}")
        self.bases = bases.contiguous()
        self._table = None

    def plain_table(self) -> torch.Tensor:
        if self._table is None:
            self._table = group.doubling_table(self.bases)
        return self._table

    def __call__(self, scalars: torch.Tensor) -> torch.Tensor:
        if scalars.shape != (self.bases.shape[0], ff.W):
            raise ValueError(f"MSM: expected scalars {(self.bases.shape[0], ff.W)}, "
                             f"got {tuple(scalars.shape)}")
        if self.bases.device.type == "cpu" and scalars.device.type == "cpu":
            return plain_msm(self.bases, scalars, self.plain_table())
        scalars = scalars.contiguous()
        kernels.check_cuda_tensor("msm bases", self.bases, torch.int32, ff.W)
        kernels.check_cuda_tensor("msm scalars", scalars, torch.int32, ff.W)
        return _launch_msm(self.bases, scalars)


def plain_msm(bases: torch.Tensor, scalars: torch.Tensor, table: torch.Tensor | None = None):
    """sum_i k_i P_i by plain PyTorch: per-lane bit selection from the
    doubling table, then one halving tree over all (bit, lane) terms."""
    if table is None:
        table = group.doubling_table(bases)
    bits = group.scalar_bits(scalars).T.bool()  # (256, N)
    terms = table[bits]  # only the set bits
    if terms.shape[0] == 0:
        return group.identity((), bases.device)
    return group.PLAIN["sum"](terms)


def msm(bases: torch.Tensor, scalars: torch.Tensor) -> torch.Tensor:
    """Variable-base MSM: sum_i scalars[i] * bases[i]."""
    return MSM(bases)(scalars)
