"""The port's Keccak-f, keccak256 and Keccak transcript (kernel D's plain
path on the CPU) against the JAX reference ``zkevm_tpu/hash/keccak.py``
and ``zkevm_tpu/transcript.py``; digests and challenges compared exactly."""

import numpy as np
import pytest
import torch

from zkevm_tpu.ec import goldens as g
from zkevm_tpu.hash import keccak as jkeccak
from zkevm_tpu.transcript import KeccakTranscript as JTranscript
from zkevm_tpu_torch import convert
from zkevm_tpu_torch.ec import group
from zkevm_tpu_torch.hash import keccak
from zkevm_tpu_torch.transcript import KeccakTranscript


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_keccak_f_matches_reference(rng):
    state = rng.integers(0, 1 << 32, size=(2, 25, 2), dtype=np.uint64).astype(np.uint32)
    got = keccak.keccak_f(convert.keccak_state_from_lohi(state))
    np.testing.assert_array_equal(convert.keccak_state_to_lohi(got), np.asarray(jkeccak.keccak_f(state)))


def test_keccak256_vectors():
    assert keccak.keccak256(b"", "cpu").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert keccak.keccak256(b"abc", "cpu").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")
    msgs = [b"", b"abc", b"x" * 135, b"y" * 136, b"z" * 300]
    got = keccak.keccak256_batch(msgs, "cpu")
    np.testing.assert_array_equal(got, jkeccak.keccak256_batch(msgs))
    for m in msgs:
        np.testing.assert_array_equal(keccak.pad_message(m).view(np.uint32).reshape(-1, 17, 2),
                                      jkeccak.pad_message(m))



def _rotl64(v, r):
    r %= 64
    return ((v << r) | (v >> (64 - r))) & ((1 << 64) - 1) if r else v


def _py_keccak_f(lanes):
    """Keccak-f[1600] on 25 python-int lanes, lane (x, y) at index x + 5y:
    a plain transcription of FIPS 202, independent of both packages."""
    a = list(lanes)
    lfsr = 1
    for _ in range(24):
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x + 4) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[i] ^ d[i % 5] for i in range(25)]
        x, y, cur = 1, 0, a[1]
        for t in range(24):
            x, y = y, (2 * x + 3 * y) % 5
            cur, a[x + 5 * y] = a[x + 5 * y], _rotl64(cur, (t + 1) * (t + 2) // 2)
        a = [a[i] ^ (~a[(i % 5 + 1) % 5 + 5 * (i // 5)] & a[(i % 5 + 2) % 5 + 5 * (i // 5)])
             for i in range(25)]
        for j in range(7):
            lfsr = ((lfsr << 1) ^ ((lfsr >> 7) * 0x71)) % 256
            if lfsr & 2:
                a[0] ^= 1 << ((1 << j) - 1)
    return a


def _py_keccak256(msg):
    padded = bytearray(msg) + b"\x01" + bytes(-(len(msg) + 1) % 136)
    padded[-1] |= 0x80
    lanes = [0] * 25
    for off in range(0, len(padded), 136):
        block = padded[off : off + 136]
        for i in range(17):
            lanes[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        lanes = _py_keccak_f(lanes)
    return b"".join(v.to_bytes(8, "little") for v in lanes[:4])


@pytest.mark.parametrize("length", [0, 1, 55, 56, 134, 135, 136, 137, 271, 272, 273, 600])
def test_keccak256_matches_python_at_padding_edges(rng, length):
    msg = rng.bytes(length)
    assert keccak.keccak256(msg, "cpu") == _py_keccak256(msg)
    assert keccak.keccak256_batch([msg, b"abc"], "cpu")[0].tobytes() == _py_keccak256(msg)

def test_transcript_challenges_match_reference(rng):
    """A scripted absorb log gives the same challenge sequence in both."""
    pts = [g.random_point(rng) for _ in range(3)] + [None]
    log = [("point", pts[0]), ("scalar", 5), ("challenge",), ("point", pts[1]),
           ("point", None), ("bytes", bytes(range(200))), ("challenge",),
           ("scalar", g.R + 3), ("point", pts[2]), ("challenge",), ("challenge",)]
    port, ref = KeccakTranscript("cpu"), JTranscript()
    got, want = [], []
    for entry in log:
        if entry[0] == "challenge":
            got.append(port.challenge())
            want.append(ref.challenge())
        elif entry[0] == "point":
            port.common_point(entry[1])
            ref.common_point(entry[1])
        elif entry[0] == "scalar":
            port.common_scalar(entry[1])
            ref.common_scalar(entry[1])
        else:
            port.common_bytes(entry[1])
            ref.common_bytes(entry[1])
    assert got == want
    # a point tensor absorbs like its affine pair
    t1, t2 = KeccakTranscript("cpu"), KeccakTranscript("cpu")
    t1.common_point(group.from_affine_ints([pts[0]], "cpu")[0])
    t2.common_point(pts[0])
    assert t1.challenge() == t2.challenge()
