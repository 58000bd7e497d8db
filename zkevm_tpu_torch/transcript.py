"""Fiat-Shamir transcripts.

Port of ``zkevm_tpu/transcript.py``, the same absorb encodings and
challenge schedules:

- ``KeccakTranscript`` (the EVM-facing proof transcript), hashing with the
  port's keccak256 on the transcript's device. Points absorb as 64 bytes
  (x || y big-endian), scalars as 32 bytes big-endian; challenge: state =
  keccak256(state || absorbed), c = state mod r.
- ``PoseidonTranscript`` (the recursion-friendly transcript of the
  aggregation layers), a host copy on the golden Poseidon sponge: a
  challenge hashes the running state and every pending field element.
"""

from __future__ import annotations

import torch

from zkevm_tpu_torch.device import resolve_device
from zkevm_tpu_torch.ec import group
from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.hash import keccak
from zkevm_tpu_torch.hash import poseidon as pos


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


class PoseidonTranscript:
    """Poseidon-sponge transcript over Fr (every absorb and squeeze is a
    field-native operation provable in-circuit)."""

    def __init__(self, spec: pos.PoseidonSpec = pos.P128_POW5_T3):
        self.spec = spec
        self._pending: list[int] = []
        self._state = 0  # running chain value

    def common_scalar(self, v: int) -> None:
        self._pending.append(v % FR_MOD)

    def common_point(self, pt) -> None:
        """pt: affine int pair (None = identity) or a (3, 8) point tensor."""
        if isinstance(pt, torch.Tensor):
            pt = group.to_affine_ints(pt)[0]
        if pt is None:
            self._pending += [0, 0, 0, 0, 0, 0]
        else:
            # Fq coordinates (Fq > Fr) absorb as three 88-bit limbs each, the
            # representation the in-circuit EC gadgets carry
            m = (1 << 88) - 1
            for c in pt:
                c = int(c)
                self._pending += [c & m, (c >> 88) & m, c >> 176]

    def common_bytes(self, raw: bytes) -> None:
        for i in range(0, len(raw), 31):
            self._pending.append(int.from_bytes(raw[i : i + 31], "big"))

    def challenge(self) -> int:
        msg = [self._state] + self._pending
        self._pending = []
        self._state = pos.hash_golden(self.spec, msg)
        return self._state

    def challenge_n(self, n: int) -> list[int]:
        return [self.challenge() for _ in range(n)]
