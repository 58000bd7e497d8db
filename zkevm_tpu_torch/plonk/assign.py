"""Witness assignment: fixed-capacity column arrays.

Port of ``zkevm_tpu/plonk/assign.py``. A circuit fills whole columns as
host numpy arrays of shape ``(n, 8)`` uint32: Montgomery words, the same
integers as the reference's ``(n, 16)`` limb arrays. The prover moves them
to the device.
"""

from __future__ import annotations

import hashlib

import numpy as np

from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.plonk.cs import Column, ConstraintSystem


class Assignment:
    """Mutable numpy buffers for every column of a ConstraintSystem."""

    def __init__(self, cs: ConstraintSystem, n: int):
        self.cs = cs
        self.n = n
        self.cols: dict[Column, np.ndarray] = {}
        for col in cs.fixed_columns + cs.advice_columns + cs.instance_columns:
            self.cols[col] = np.zeros((n, ff.W), dtype=np.uint32)

    # -- setters ---------------------------------------------------------
    def set_int(self, col: Column, row: int, value: int) -> None:
        self.cols[col][row] = FR.encode(value)

    def set_ints(self, col: Column, start: int, values) -> None:
        vals = [int(v) for v in values]
        if vals:
            self.cols[col][start : start + len(vals)] = FR.encode_many(vals)

    # -- getters ---------------------------------------------------------
    def get_int(self, col: Column, row: int) -> int:
        return FR.decode(self.cols[col][row])

    def digest(self) -> str:
        """sha256 of every column's words (little-endian uint32), fixed,
        advice and instance columns in the constraint system's order."""
        h = hashlib.sha256()
        for col in self.cs.fixed_columns + self.cs.advice_columns + self.cs.instance_columns:
            h.update(np.ascontiguousarray(self.cols[col], dtype="<u4").tobytes())
        return h.hexdigest()
