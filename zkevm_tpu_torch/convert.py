"""Conversions between the reference's arrays and the port's tensors.

The reference (``zkevm_tpu``) stores field elements as ``(..., 16)``
uint32 arrays of 16-bit limbs; the port as ``(..., 8)`` int32 words. Both
hold the same 256-bit integers (Montgomery form, R = 2^256), so conversion
is a repack. Lazy-13 values (``ff/lazy13.py``) are ``(21, ...)`` in both, the
reference's uint32 and the port's int32, the same words. These helpers take
and return numpy arrays and tensors only; nothing here imports the reference
package. The three that make tensors (``limbs16_to_words``,
``l13_from_reference``, ``params_from_numpy``) put them on the card unless
the caller passes ``device="cpu"``, as every entry point of the port does.
"""

from __future__ import annotations

import numpy as np
import torch

from zkevm_tpu_torch.device import resolve_device
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.kzg.params import ParamsKZG
from zkevm_tpu_torch.plonk.assign import Assignment


def limbs16_to_words(a, device=None) -> torch.Tensor:
    """(..., 16) uint32 16-bit limbs (numpy) -> (..., 8) int32 tensor."""
    return ff.to_tensor(ff.words_from_limbs16(a), resolve_device(device))


def words_to_limbs16(t) -> np.ndarray:
    """(..., 8) words (tensor or numpy) -> (..., 16) uint32 16-bit limbs."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    w = np.asarray(t).astype(np.uint32)
    return np.stack([w & 0xFFFF, w >> 16], axis=-1).reshape(*w.shape[:-1], 16).astype(np.uint32)


def l13_from_reference(a, device=None) -> torch.Tensor:
    """(21, ...) uint32 lazy-13 limbs (the reference's) -> (21, ...) int32 tensor."""
    a = np.asarray(a, dtype=np.uint32)
    if a.ndim < 1 or a.shape[0] != 21:
        raise ValueError(f"lazy-13 values must be (21, ...), got {a.shape}")
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy()).to(resolve_device(device))


def l13_to_reference(t) -> np.ndarray:
    """(21, ...) lazy-13 limbs (tensor or numpy) -> (21, ...) uint32, the reference's layout."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t).astype(np.int64).astype(np.uint32)


def keccak_state_from_lohi(a) -> torch.Tensor:
    """(..., 25, 2) uint32 (lo, hi) lanes -> (..., 25) int64 tensor."""
    a = np.asarray(a, dtype=np.uint64)
    lanes = a[..., 0] | (a[..., 1] << np.uint64(32))
    return torch.from_numpy(lanes.view(np.int64).copy())


def keccak_state_to_lohi(t: torch.Tensor) -> np.ndarray:
    lanes = t.detach().cpu().numpy().view(np.uint64)
    return np.stack([lanes & np.uint64(0xFFFFFFFF), lanes >> np.uint64(32)], axis=-1).astype(np.uint32)


def params_from_numpy(g1_x, g1_y, g1_z, g2, s_g2, device=None) -> ParamsKZG:
    """Port ParamsKZG from the reference's SRS arrays: (n, 16) Montgomery
    Fq limbs per Jacobian coordinate, and the host G2 points."""
    pts = np.stack([ff.words_from_limbs16(c) for c in (g1_x, g1_y, g1_z)], axis=1)
    n = pts.shape[0]
    k = n.bit_length() - 1
    if 1 << k != n:
        raise ValueError(f"SRS size {n} is not a power of two")
    return ParamsKZG(k=k, g1_powers=ff.to_tensor(pts, resolve_device(device)), g2=g2, s_g2=s_g2)


def columns_from_numpy(columns: dict, cs) -> dict:
    """Reference assignment columns ({column: (n, 16) limbs}) -> the port's
    columns of ``cs`` ({Column: (n, 8) uint32 words}), matched by
    (kind, index, phase)."""
    by_key = {(c.kind, c.index, c.phase): c
              for c in cs.fixed_columns + cs.advice_columns + cs.instance_columns}
    return {by_key[(c.kind, c.index, c.phase)]: ff.words_from_limbs16(v) for c, v in columns.items()}


def assignment_from_reference(ref_asg, cs) -> Assignment:
    """A reference ``Assignment`` (numpy (n, 16) limbs per column) -> the
    port's ``Assignment`` of ``cs`` ((n, 8) words per column)."""
    asg = Assignment(cs, ref_asg.n)
    asg.cols.update(columns_from_numpy(ref_asg.cols, cs))
    return asg


def columns_to_reference(asg: Assignment, ref_cs) -> dict:
    """The port's ``Assignment`` -> {column of the reference's ``ref_cs``:
    (n, 16) uint32 limbs}, matched by (kind, index, phase): the columns of
    a reference ``Assignment``."""
    by_key = {(c.kind, c.index, c.phase): c
              for c in ref_cs.fixed_columns + ref_cs.advice_columns + ref_cs.instance_columns}
    return {by_key[(c.kind, c.index, c.phase)]: words_to_limbs16(v) for c, v in asg.cols.items()}


__all__ = [
    "assignment_from_reference",
    "columns_from_numpy",
    "columns_to_reference",
    "keccak_state_from_lohi",
    "keccak_state_to_lohi",
    "l13_from_reference",
    "l13_to_reference",
    "limbs16_to_words",
    "params_from_numpy",
    "words_to_limbs16",
]
