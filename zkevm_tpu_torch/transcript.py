"""Fiat-Shamir transcript (Keccak).

Port of ``zkevm_tpu/transcript.py::KeccakTranscript``: the same absorb
encoding and challenge schedule, hashing with the port's keccak256 on the
transcript's device. Points absorb as 64 bytes (x || y big-endian),
scalars as 32 bytes big-endian; challenge: state = keccak256(state ||
absorbed), c = state mod r.
"""

from __future__ import annotations

import torch

from zkevm_tpu_torch.device import resolve_device
from zkevm_tpu_torch.ec import group
from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.hash import keccak


class KeccakTranscript:
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._buf = bytearray()
        self._state = b"\x00" * 32

    def common_point(self, pt) -> None:
        """pt: affine int pair (None = identity) or a (3, 8) point tensor."""
        if isinstance(pt, torch.Tensor):
            pt = group.to_affine_ints(pt)[0]
        x, y = (0, 0) if pt is None else pt
        self._buf += int(x).to_bytes(32, "big") + int(y).to_bytes(32, "big")

    def common_scalar(self, v: int) -> None:
        self._buf += int(v % FR_MOD).to_bytes(32, "big")

    def common_bytes(self, raw: bytes) -> None:
        self._buf += raw

    def challenge(self) -> int:
        self._state = keccak.keccak256(self._state + bytes(self._buf), self.device)
        self._buf = bytearray()
        return int.from_bytes(self._state, "big") % FR_MOD
