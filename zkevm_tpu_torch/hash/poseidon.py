"""Poseidon over BN254 Fr on torch tensors (kernel E and its plain version).

Port of ``zkevm_tpu/hash/poseidon.py``. The constant generation (Grain LFSR
and Cauchy MDS), the spec and the host golden permutation and sponge are
copies of the reference's host code. The batched permutation works on
``(..., t, 8)`` int32 Montgomery Fr words (R = 2^256, the same integers as
the reference's ``(..., t, 16)`` limbs):

- ``permute``: N states in, N states out;
- ``permute_trace``: every state of each permutation (the input, then the
  state after each round), lane-major ``(t, N, R + 1, 8)``: lane i of a
  batch is one column of the PoseidonTable's rows;
- ``hash_many``: the ConstantLength sponge (zero padding to the rate, the
  capacity lane 2^64 * L for the unpadded length L).

On a CUDA tensor each runs kernel E (``csrc/poseidon.cu``, P128Pow5T3
only); on a CPU tensor the plain version below, built from the field's
plain operations.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from zkevm_tpu_torch import kernels
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FR_MOD


# ---------------------------------------------------------------------------
# Grain LFSR (Poseidon reference constant generation), a copy
# ---------------------------------------------------------------------------

class _Grain:
    def __init__(self, t: int, r_f: int, r_p: int, n_bits: int = 255):
        bits = []

        def append(value: int, width: int):
            for i in range(width - 1, -1, -1):
                bits.append((value >> i) & 1)

        append(1, 2)       # field type: prime
        append(0, 4)       # sbox: x^alpha
        append(n_bits, 12)  # field size in bits
        append(t, 12)
        append(r_f, 10)
        append(r_p, 10)
        append((1 << 30) - 1, 30)
        assert len(bits) == 80
        self.state = bits
        self.n_bits = n_bits
        for _ in range(160):
            self._next_bit()

    def _next_bit(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new)
        return new

    def _sample_bit(self) -> int:
        # shrinking generator: emit the second bit of a pair iff the first is 1
        while True:
            if self._next_bit() == 1:
                return self._next_bit()

    def next_field_element(self, p: int = FR_MOD) -> int:
        """Rejection-sample a field element (used for round constants)."""
        while True:
            v = 0
            for _ in range(self.n_bits):
                v = (v << 1) | self._sample_bit()
            if v < p:
                return v

    def next_field_element_without_rejection(self, p: int = FR_MOD) -> int:
        """Reduce mod p without rejection (used for MDS x/y vectors)."""
        v = 0
        for _ in range(self.n_bits):
            v = (v << 1) | self._sample_bit()
        return v % p


@dataclass(frozen=True)
class PoseidonSpec:
    """Poseidon instance parameters; t = rate + capacity(1), alpha = 5."""

    t: int
    r_f: int  # total full rounds (split half before / half after partials)
    r_p: int

    @property
    def rate(self) -> int:
        return self.t - 1


P128_POW5_T3 = PoseidonSpec(t=3, r_f=8, r_p=56)


@lru_cache(maxsize=None)
def generate_constants(spec: PoseidonSpec):
    """-> (round_constants [(r_f + r_p) x t ints], mds [t x t ints])."""
    grain = _Grain(spec.t, spec.r_f, spec.r_p)
    rc = [
        [grain.next_field_element() for _ in range(spec.t)]
        for _ in range(spec.r_f + spec.r_p)
    ]
    # Cauchy MDS: M[i][j] = 1 / (x_i + y_j)
    while True:
        xs = [grain.next_field_element_without_rejection() for _ in range(spec.t)]
        ys = [grain.next_field_element_without_rejection() for _ in range(spec.t)]
        flat = xs + ys
        if len(set(flat)) == 2 * spec.t and all(
            (x + y) % FR_MOD != 0 for x in xs for y in ys
        ):
            break
    mds = [
        [pow((xs[i] + ys[j]) % FR_MOD, FR_MOD - 2, FR_MOD) for j in range(spec.t)]
        for i in range(spec.t)
    ]
    return rc, mds


# ---------------------------------------------------------------------------
# Host golden permutation and sponge, copies
# ---------------------------------------------------------------------------

def permute_golden(spec: PoseidonSpec, state: list[int]) -> list[int]:
    rc, mds = generate_constants(spec)
    p = FR_MOD
    t = spec.t
    half = spec.r_f // 2
    s = list(state)

    def full_round(r):
        nonlocal s
        s = [pow((s[i] + rc[r][i]) % p, 5, p) for i in range(t)]
        s = [sum(mds[i][j] * s[j] for j in range(t)) % p for i in range(t)]

    def partial_round(r):
        nonlocal s
        s = [(s[i] + rc[r][i]) % p for i in range(t)]
        s[0] = pow(s[0], 5, p)
        s = [sum(mds[i][j] * s[j] for j in range(t)) % p for i in range(t)]

    r = 0
    for _ in range(half):
        full_round(r)
        r += 1
    for _ in range(spec.r_p):
        partial_round(r)
        r += 1
    for _ in range(half):
        full_round(r)
        r += 1
    return s


def hash_golden(spec: PoseidonSpec, msg: list[int]) -> int:
    """ConstantLength<L> Poseidon hash (host golden): the capacity lane
    starts at 2^64 * L, the message is zero-padded to the rate."""
    rate = spec.rate
    cap = (1 << 64) * len(msg) % FR_MOD
    padded = list(msg) + [0] * ((-len(msg)) % rate)
    state = [0] * rate + [cap]
    for i in range(0, len(padded), rate):
        for j in range(rate):
            state[j] = (state[j] + padded[i + j]) % FR_MOD
        state = permute_golden(spec, state)
    return state[0]


# ---------------------------------------------------------------------------
# Plain PyTorch version (the field's plain operations)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _constant_words(spec: PoseidonSpec) -> tuple[np.ndarray, np.ndarray]:
    """(R, t, 8) round constants and (t, t, 8) MDS, Montgomery words."""
    rc, mds = generate_constants(spec)
    rc_m = FR.encode_many([c for row in rc for c in row]).reshape(len(rc), spec.t, ff.W)
    mds_m = FR.encode_many([c for row in mds for c in row]).reshape(spec.t, spec.t, ff.W)
    return rc_m, mds_m


@lru_cache(maxsize=16)
def _constants(spec: PoseidonSpec, device: str) -> tuple[torch.Tensor, torch.Tensor]:
    rc_m, mds_m = _constant_words(spec)
    return ff.to_tensor(rc_m, device), ff.to_tensor(mds_m, device)


def _plain_rounds(spec: PoseidonSpec, state: torch.Tensor):
    """Yield the state after each round of the plain permutation."""
    rc, mds = _constants(spec, str(state.device))
    add, mul = ff.PLAIN["add"], ff.PLAIN["mul"]
    half = spec.r_f // 2

    def sbox(x):
        x2 = mul(FR, x, x)
        x4 = mul(FR, x2, x2)
        return mul(FR, x4, x)

    s = state
    for r in range(spec.r_f + spec.r_p):
        s = add(FR, s, rc[r])
        if r < half or r >= half + spec.r_p:
            s = sbox(s)
        else:
            s = torch.cat([sbox(s[..., :1, :]), s[..., 1:, :]], dim=-2)
        prod = mul(FR, mds, s[..., None, :, :])  # (..., t, t, 8): mds[i][j] * s[j]
        acc = prod[..., 0, :]
        for j in range(1, spec.t):
            acc = add(FR, acc, prod[..., j, :])
        s = acc
        yield s


def _plain_permute(spec: PoseidonSpec, state: torch.Tensor) -> torch.Tensor:
    s = state
    for s in _plain_rounds(spec, state):
        pass
    return s


def _plain_trace(spec: PoseidonSpec, state: torch.Tensor) -> torch.Tensor:
    """(N, t, 8) -> (t, N, R + 1, 8)."""
    states = [state] + list(_plain_rounds(spec, state))
    return torch.stack(states, dim=1).permute(2, 0, 1, 3).contiguous()


def _capacity_word(length: int) -> np.ndarray:
    return FR.encode((1 << 64) * length % FR_MOD)


def _plain_hash_many(spec: PoseidonSpec, msgs: torch.Tensor) -> torch.Tensor:
    """(N, L, 8) -> (N, 8), the sponge of ``hash_many``."""
    n, length = msgs.shape[0], msgs.shape[1]
    rate = spec.rate
    pad = (-length) % rate
    if pad:
        msgs = torch.cat([msgs, msgs.new_zeros(n, pad, ff.W)], dim=1)
    cap = ff.to_tensor(_capacity_word(length), msgs.device)
    state = torch.cat([msgs.new_zeros(n, rate, ff.W), cap.expand(n, 1, ff.W)], dim=1)
    for i in range(0, length + pad, rate):
        absorbed = ff.PLAIN["add"](FR, state[:, :rate], msgs[:, i : i + rate])
        state = _plain_permute(spec, torch.cat([absorbed, state[:, rate:]], dim=1))
    return state[:, 0]


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

_loaded: set = set()  # CUDA devices whose constant memory holds the constants


def _check_spec(spec: PoseidonSpec) -> None:
    if spec != P128_POW5_T3:
        raise ValueError(f"kernel E implements P128Pow5T3 only, got {spec}")


def _load_constants(spec: PoseidonSpec, device: torch.device) -> None:
    key = torch.cuda.current_device() if device.index is None else device.index
    if key in _loaded:
        return
    rc_m, mds_m = (np.ascontiguousarray(a) for a in _constant_words(spec))
    with torch.cuda.device(key):
        kernels.call("poseidon", "zk_poseidon_constants", rc_m.ctypes.data, mds_m.ctypes.data)
    _loaded.add(key)


def _check_states(spec: PoseidonSpec, name: str, t: torch.Tensor) -> None:
    kernels.check_cuda_tensor(name, t, torch.int32, ff.W)
    if t.dim() < 2 or t.shape[-2] != spec.t:
        raise ValueError(f"{name}: expected (..., {spec.t}, 8), got {tuple(t.shape)}")


def _on_cpu(t: torch.Tensor) -> bool:
    if t.dtype != torch.int32 or t.dim() < 2 or t.shape[-1] != ff.W:
        raise ValueError(f"poseidon: expected int32 (..., 8) words, got {t.dtype} {tuple(t.shape)}")
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"poseidon: unsupported device {t.device}")


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def permute(spec: PoseidonSpec, state: torch.Tensor) -> torch.Tensor:
    """Batched Poseidon permutation. state: (..., t, 8) Montgomery Fr."""
    if _on_cpu(state):
        return _plain_permute(spec, state)
    _check_spec(spec)
    state = state.contiguous()
    _check_states(spec, "poseidon state", state)
    _load_constants(spec, state.device)
    out = torch.empty_like(state)
    n = state.numel() // (spec.t * ff.W)
    if n:
        kernels.launch("poseidon", "poseidon", "zk_poseidon_permute", out.data_ptr(),
                       state.data_ptr(), n)
    return out


def permute_trace(spec: PoseidonSpec, state: torch.Tensor) -> torch.Tensor:
    """(N, t, 8) initial states -> (t, N, R + 1, 8): entry [i, p, r] is lane
    i of permutation p before round r (r = R: the output)."""
    if state.dim() != 3:
        raise ValueError(f"permute_trace: expected (N, t, 8), got {tuple(state.shape)}")
    if _on_cpu(state):
        return _plain_trace(spec, state)
    _check_spec(spec)
    state = state.contiguous()
    _check_states(spec, "poseidon state", state)
    _load_constants(spec, state.device)
    n = state.shape[0]
    rounds = spec.r_f + spec.r_p
    out = torch.empty(spec.t, n, rounds + 1, ff.W, dtype=torch.int32, device=state.device)
    if n:
        kernels.launch("poseidon", "poseidon", "zk_poseidon_trace", out.data_ptr(),
                       state.data_ptr(), n)
    return out


def hash_many(spec: PoseidonSpec, msgs: torch.Tensor) -> torch.Tensor:
    """Batched fixed-length hash. msgs: (N, L, 8) Montgomery Fr words ->
    (N, 8) Montgomery digests."""
    if msgs.dim() != 3:
        raise ValueError(f"hash_many: expected (N, L, 8), got {tuple(msgs.shape)}")
    if _on_cpu(msgs):
        return _plain_hash_many(spec, msgs)
    _check_spec(spec)
    msgs = msgs.contiguous()
    kernels.check_cuda_tensor("poseidon messages", msgs, torch.int32, ff.W)
    _load_constants(spec, msgs.device)
    n, length = msgs.shape[0], msgs.shape[1]
    out = torch.empty(n, ff.W, dtype=torch.int32, device=msgs.device)
    cap = (ctypes.c_uint32 * 8)(*_capacity_word(length).tolist())
    if n:
        kernels.launch("poseidon", "poseidon", "zk_poseidon_hash_many", out.data_ptr(),
                       msgs.data_ptr(), n, length, ctypes.addressof(cap))
    return out


PLAIN = {"permute": _plain_permute, "trace": _plain_trace, "hash_many": _plain_hash_many}
