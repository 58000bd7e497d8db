"""SRS (structured reference string) files in the halo2 layout.

Port of ``zkevm_tpu/kzg/srs.py``. Scroll's provers load
perpetual-powers-of-tau params files in halo2's
``SerdeFormat::RawBytesUnchecked`` layout and reject any file whose
``s_g2`` is not the known production point (``prover/src/utils.rs:36-84``
in the Rust reference). The layout, read and written byte for byte:

    [k: u32 LE]
    [2^k G1 points, 64 B each: x||y, Fq raw]      (monomial basis g)
    [2^k G1 points, 64 B each]                    (lagrange basis)
    [G2 point, 128 B: x.c0||x.c1||y.c0||y.c1]     (g2)
    [G2 point, 128 B]                             (s_g2)

Fq "raw bytes" = the Montgomery-form residue (R = 2^256, as in
halo2curves) as 32 little-endian bytes: exactly the port's storage form, 8
little-endian 32-bit words, so the points cross without arithmetic.
Identity encodes as zeros.

Writing normalises both G1 sections to affine on the device (kernel A's
batched Fq inversion) and computes the Lagrange section [L_i(tau)]G1 there
(kernel A for L_i(tau), kernel C's per-lane scalar multiplication).
Loading checks what the reference checks and attaches the reference's
commit engine: the Pippenger MSM (kernel G) at k > 10, kernel C's MSM
otherwise.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from zkevm_tpu_torch.device import resolve_device
from zkevm_tpu_torch.ec import goldens as g1g, group, pairing as pr
from zkevm_tpu_torch.ec.pippenger import PippengerMSM
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FQ, FR
from zkevm_tpu_torch.ff.goldens import FQ_MOD, FR_MOD, fr_root_of_unity
from zkevm_tpu_torch.kzg.params import ParamsKZG
from zkevm_tpu_torch.poly import ntt as nttmod

R256 = 1 << 256
R_INV = pow(R256 % FQ_MOD, FQ_MOD - 2, FQ_MOD)
PIPPENGER_MIN_K = 11  # the reference's loader commits through PippengerMSMT above k = 10

# The production perpetual-powers-of-tau [tau]G2 (prover/src/utils.rs:36).
SCROLL_S_G2 = (
    (
        0x17944351223333F260DDC3B4AF45191B856689EDA9EAB5CBCDDBBE570CE860D2,
        0x186282957DB913ABD99F91DB59FE69922E95040603EF44C0BD7AA3ADEEF8F5AC,
    ),
    (
        0x297772D34BC9AA8AE56162486363FFE417B02DC7E8C207FC2CC20203E67A02AD,
        0x298ADC7396BD3865CBF6D6DF91BAE406694E6D2215BAA893BDEADB63052895F4,
    ),
)


def _fq_raw(v: int) -> bytes:
    return (v * R256 % FQ_MOD).to_bytes(32, "little")


def _fq_unraw(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= FQ_MOD:
        raise ValueError("non-canonical Fq raw bytes")
    return v * R_INV % FQ_MOD


def _g2_raw(pt) -> bytes:
    (xc0, xc1), (yc0, yc1) = pt
    return _fq_raw(xc0) + _fq_raw(xc1) + _fq_raw(yc0) + _fq_raw(yc1)


def _g2_unraw(b: bytes):
    vals = [_fq_unraw(b[i : i + 32]) for i in range(0, 128, 32)]
    return ((vals[0], vals[1]), (vals[2], vals[3]))


def params_path(params_dir: str, k: int) -> str:
    """The reference's per-degree file naming (utils.rs param_path_for_degree)."""
    return os.path.join(params_dir, f"params{k}")


def _affine_raw(points: torch.Tensor) -> np.ndarray:
    """(n, 3, 8) Jacobian -> (n, 2, 8) uint32 words of the affine x, y in
    Montgomery form (zeros for the identity), by one batched inversion."""
    zinv = ff.inv(FQ, points[:, 2])
    zinv2 = ff.sqr(FQ, zinv)
    x = ff.mont_mul(FQ, points[:, 0], zinv2)
    y = ff.mont_mul(FQ, points[:, 1], ff.mont_mul(FQ, zinv2, zinv))
    return ff.to_words(torch.stack([x, y], dim=1))


def lagrange_scalars(k: int, tau: int, device) -> torch.Tensor:
    """(n, 8) standard-form L_i(tau) = (tau^n - 1) w^i / (n (tau - w^i))."""
    n = 1 << k
    tau %= FR_MOD
    xs = nttmod.power_table(fr_root_of_unity(k), n, device)  # w^i
    d = ff.inv(FR, ff.sub(FR, FR.const(tau, device), xs))
    scale = (pow(tau, n, FR_MOD) - 1) * pow(n, FR_MOD - 2, FR_MOD) % FR_MOD
    lag = ff.mont_mul(FR, ff.mont_mul(FR, xs, d), FR.const(scale, device))
    return ff.from_mont(FR, lag)


def write_params_file(params: ParamsKZG, path: str, *, tau: int) -> None:
    """Write a test SRS in the halo2 layout. ``tau`` is required to compute
    the lagrange-basis section ([L_i(tau)]G1) without an EC-NTT: only test
    SRS from ``unsafe_setup`` are written locally (production files come
    from the ceremony, as in the reference). Runs on the params' device."""
    dev = params.device
    mono = _affine_raw(params.g1_powers)
    gen = group.from_affine_ints([g1g.G1_GEN], dev)[0]
    lag = _affine_raw(group.scalar_mul(gen, lagrange_scalars(params.k, tau, dev)))
    with open(path, "wb") as f:
        f.write(int(params.k).to_bytes(4, "little"))
        f.write(mono.astype("<u4").tobytes())
        f.write(lag.astype("<u4").tobytes())
        f.write(_g2_raw(params.g2))
        f.write(_g2_raw(params.s_g2))


def _raw_int(words: np.ndarray) -> int:
    return int.from_bytes(words.astype("<u4").tobytes(), "little")


def load_params_file(path_or_dir: str, k: int | None = None, *, expected_s_g2=None,
                     device=None) -> ParamsKZG:
    """Load a halo2-layout params file onto ``device`` (CUDA by default).

    Checks, as the reference does (prover/src/utils.rs:55-80): the degree
    when ``k`` is given, the length, canonical G2 bytes, g1[0] and g1[n-1]
    on the curve, g2 and s_g2 on the curve, and (when ``expected_s_g2`` is
    given, e.g. SCROLL_S_G2 for production files) the s_g2 fingerprint.
    The lagrange section is skipped: commitments go through the iNTT."""
    device = resolve_device(device)
    path = path_or_dir
    if os.path.isdir(path_or_dir):
        if k is None:
            raise ValueError("need k to pick a file from a params dir")
        path = params_path(path_or_dir, k)
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        kf = int.from_bytes(f.read(4), "little")
        if k is not None and kf != k:
            raise ValueError(f"params file has k={kf}, expected {k}")
        n = 1 << kf
        expected = 4 + 2 * n * 64 + 2 * 128
        if size != expected:
            raise ValueError(
                f"invalid params file len {size} for degree {kf} (expected {expected})"
            )
        raw = np.frombuffer(f.read(n * 64), dtype="<u4").reshape(n, 2, ff.W)
        f.seek(n * 64, 1)
        g2 = _g2_unraw(f.read(128))
        s_g2 = _g2_unraw(f.read(128))

    # spot validation, as the reference: the first and last points on the
    # curve (cofactor 1 makes on-curve sufficient)
    for i in (0, n - 1):
        x = _raw_int(raw[i, 0]) * R_INV % FQ_MOD
        y = _raw_int(raw[i, 1]) * R_INV % FQ_MOD
        if (y * y - x * x * x - 3) % FQ_MOD != 0:
            raise ValueError(f"g1[{i}] not on curve")
    if not pr.g2_is_on_curve(g2) or not pr.g2_is_on_curve(s_g2):
        raise ValueError("g2/s_g2 not on curve")
    if expected_s_g2 is not None and s_g2 != tuple(map(tuple, expected_s_g2)):
        raise ValueError("wrong params file: s_g2 fingerprint mismatch")

    words = np.empty((n, 3, ff.W), dtype=np.uint32)
    words[:, :2] = raw
    words[:, 2] = FQ.encode(1)
    g1_powers = ff.to_tensor(words, device)
    committer = PippengerMSM(g1_powers) if kf >= PIPPENGER_MIN_K else None
    return ParamsKZG(k=kf, g1_powers=g1_powers, g2=g2, s_g2=s_g2, committer=committer)
