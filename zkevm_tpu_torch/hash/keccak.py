"""Keccak-f[1600] and keccak256 on torch tensors (kernel D and its plain
version).

Port of ``zkevm_tpu/hash/keccak.py``. The state is ``(..., 25)``
``torch.int64``: native 64-bit lanes (the bit patterns of uint64), lane
``i = 5y + x``. The reference keeps each lane as a (lo, hi) pair of uint32
because the TPU has no 64-bit integers; ``zkevm_tpu_torch.convert`` maps
between the two. On CUDA tensors the permutation and the sponge run the
kernels in ``csrc/keccak.cu``; on CPU tensors the plain version below.
"""

from __future__ import annotations

import numpy as np
import torch

from zkevm_tpu_torch import kernels
from zkevm_tpu_torch.device import resolve_device

_ROT = [
    0, 1, 62, 28, 27,
    36, 44, 6, 55, 20,
    3, 10, 43, 25, 39,
    41, 45, 15, 21, 8,
    18, 2, 61, 56, 14,
]

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

RATE_BYTES = 136  # keccak256 rate (17 lanes)


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    if r == 0:
        return v
    # int64 >> is arithmetic: mask off the sign copies
    return (v << r) | ((v >> (64 - r)) & ((1 << r) - 1))


def _plain_keccak_f(state: torch.Tensor) -> torch.Tensor:
    a = list(state.unbind(-1))
    for rnd in range(24):
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        b = [None] * 25
        for y in range(5):
            for x in range(5):
                b[5 * ((2 * x + 3 * y) % 5) + y] = _rotl(a[5 * y + x], _ROT[5 * y + x])
        a = [b[5 * y + x] ^ (~b[5 * y + (x + 1) % 5] & b[5 * y + (x + 2) % 5])
             for y in range(5) for x in range(5)]
        a[0] = a[0] ^ _signed(_RC[rnd])
    return torch.stack(a, dim=-1)


def _plain_sponge(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    n, max_blocks = blocks.shape[0], blocks.shape[1]
    state = torch.zeros(n, 25, dtype=torch.int64, device=blocks.device)
    digest = torch.zeros(n, 4, dtype=torch.int64, device=blocks.device)
    for j in range(max_blocks):
        state = torch.cat([state[:, :17] ^ blocks[:, j], state[:, 17:]], dim=1)
        state = _plain_keccak_f(state)
        digest = torch.where((nblocks == j + 1)[:, None], state[:, :4], digest)
    return digest


def keccak_f(state: torch.Tensor) -> torch.Tensor:
    """Apply keccak-f[1600] to every (..., 25) int64 state."""
    if state.shape[-1] != 25 or state.dtype != torch.int64:
        raise ValueError(f"keccak_f: expected (..., 25) int64, got {state.dtype} {tuple(state.shape)}")
    if state.device.type == "cpu":
        return _plain_keccak_f(state)
    out = state.contiguous().clone()
    kernels.check_cuda_tensor("keccak state", out, torch.int64, 25)
    kernels.launch("keccak", "keccak", "zk_keccak_f", out.data_ptr(), out.numel() // 25)
    return out


def pad_message(msg: bytes) -> np.ndarray:
    """keccak padding (0x01 ... 0x80) -> (nblocks, 17) uint64 lanes."""
    padded = bytearray(msg)
    pad_len = RATE_BYTES - (len(msg) % RATE_BYTES)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    return np.frombuffer(bytes(padded), dtype="<u8").reshape(-1, 17)


def sponge(blocks: torch.Tensor, nblocks: torch.Tensor) -> torch.Tensor:
    """blocks (n, max_blocks, 17) int64, nblocks (n,) int32 -> (n, 4)
    int64 digest lanes (the first 32 bytes of each squeezed state)."""
    if blocks.device.type == "cpu":
        return _plain_sponge(blocks, nblocks)
    kernels.check_cuda_tensor("keccak blocks", blocks, torch.int64, 17)
    kernels.check_cuda_tensor("keccak nblocks", nblocks, torch.int32, None)
    n = blocks.shape[0]
    if blocks.dim() != 3 or nblocks.shape != (n,):
        raise ValueError("keccak sponge: blocks (n, max_blocks, 17) and nblocks (n,) expected")
    digest = torch.empty(n, 4, dtype=torch.int64, device=blocks.device)
    kernels.launch("keccak", "keccak", "zk_keccak_sponge", blocks.data_ptr(), nblocks.data_ptr(),
                   blocks.shape[1], digest.data_ptr(), n)
    return digest


def _pack(msgs: list[bytes], device) -> tuple[torch.Tensor, torch.Tensor]:
    padded = [pad_message(m) for m in msgs]
    max_blocks = max(p.shape[0] for p in padded)
    data = np.zeros((len(msgs), max_blocks, 17), dtype=np.uint64)
    nblk = np.zeros(len(msgs), dtype=np.int32)
    for i, p in enumerate(padded):
        data[i, : p.shape[0]] = p
        nblk[i] = p.shape[0]
    return (torch.from_numpy(data.view(np.int64)).to(device),
            torch.from_numpy(nblk).to(device))


def keccak256_batch(msgs: list[bytes], device=None) -> np.ndarray:
    """Batch of variable-length messages -> (N, 32) uint8 digests."""
    device = resolve_device(device)
    blocks, nblk = _pack(msgs, device)
    lanes = sponge(blocks, nblk).cpu().numpy().view(np.uint64).astype("<u8")
    return np.frombuffer(lanes.tobytes(), dtype=np.uint8).reshape(len(msgs), 32)


def keccak256(msg: bytes, device=None) -> bytes:
    """Single-message keccak256."""
    return keccak256_batch([msg], device)[0].tobytes()


PLAIN = {"keccak_f": _plain_keccak_f, "sponge": _plain_sponge}
