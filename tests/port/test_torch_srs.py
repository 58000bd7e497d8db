"""The port's halo2-layout SRS files (``zkevm_tpu_torch/kzg/srs.py``) against
the reference's ``zkevm_tpu/kzg/srs.py``: byte-equal files, each package
loading the other's file, every rejection of the reference's loader with
its message, and the Pippenger engine a file gets above k = 10."""

import json
from pathlib import Path

import pytest
import torch

from zkevm_tpu.ec import group as jgroup
from zkevm_tpu.kzg import srs as jsrs
from zkevm_tpu_torch.ec import goldens as g, group, pairing as pr
from zkevm_tpu_torch.ec.pippenger import PippengerMSM
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.kzg import ParamsKZG, srs

VEC = json.loads((Path(__file__).resolve().parents[1] / "vectors" / "torch_port_kzg.json").read_text())
TAU = VEC["srs"]["tau"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def port_files(tmp_path_factory):
    """The port's files params4 and params6, written on the CPU."""
    d = tmp_path_factory.mktemp("srs")
    for k in VEC["srs"]["ks"]:
        srs.write_params_file(ParamsKZG.unsafe_setup(k, tau=TAU, device="cpu"), srs.params_path(str(d), k),
                              tau=TAU)
    return d


def _golden_powers(k):
    return [g.scalar_mul(g.G1_GEN, pow(TAU, i, FR_MOD)) for i in range(1 << k)]


@pytest.mark.parametrize("k", VEC["srs"]["ks"])
def test_file_bytes_equal_reference(port_files, k):
    got = Path(srs.params_path(str(port_files), k)).read_bytes()
    assert len(got) == 4 + 2 * (1 << k) * 64 + 256
    assert got.hex() == VEC["srs_files"][str(k)]


def test_reference_loads_port_file(port_files):
    loaded = jsrs.load_params_file(str(port_files), 6)
    assert jgroup.to_affine_ints(loaded.g1_powers) == _golden_powers(6)
    assert loaded.s_g2 == pr.g2_scalar_mul(pr.G2_GEN, TAU)


def test_port_loads_reference_file(tmp_path):
    path = tmp_path / "params6"
    path.write_bytes(bytes.fromhex(VEC["srs_files"]["6"]))
    loaded = srs.load_params_file(str(tmp_path), 6, device="cpu")
    assert loaded.k == 6 and loaded.g1_powers.shape == (64, 3, 8)
    assert group.to_affine_ints(loaded.g1_powers) == _golden_powers(6)
    assert loaded.g2 == pr.G2_GEN and loaded.s_g2 == pr.g2_scalar_mul(pr.G2_GEN, TAU)
    assert not isinstance(loaded.committer, PippengerMSM)


def _off_curve_g1(data: bytearray, i: int) -> None:
    off = 4 + 64 * i
    data[off] ^= 1  # the low bit of x's residue: still canonical, off the curve


def _g2_offset(n: int) -> int:
    return 4 + 2 * n * 64


REJECTIONS = {
    "len": (lambda d, n: d.__delitem__(slice(len(d) - 64, None)), {}, "len"),
    "k": (lambda d, n: None, {"k": 5}, "expected"),
    "fingerprint": (lambda d, n: None, {"expected_s_g2": srs.SCROLL_S_G2}, "fingerprint"),
    "g1_first": (lambda d, n: _off_curve_g1(d, 0), {}, r"g1\[0\] not on curve"),
    "g1_last": (lambda d, n: _off_curve_g1(d, n - 1), {}, r"g1\[63\] not on curve"),
    "g2": (lambda d, n: d.__setitem__(_g2_offset(n), d[_g2_offset(n)] ^ 1), {}, "not on curve"),
    "non_canonical": (lambda d, n: d.__setitem__(slice(_g2_offset(n), _g2_offset(n) + 32), b"\xff" * 32),
                      {}, "non-canonical"),
}


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_loaders_reject_alike(tmp_path, case):
    """Each fault, in one file, raises the same ValueError in both loaders."""
    tamper, kwargs, match = REJECTIONS[case]
    data = bytearray.fromhex(VEC["srs_files"]["6"])
    tamper(data, 64)
    path = tmp_path / "params6"
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=match):
        jsrs.load_params_file(str(path), **kwargs)
    with pytest.raises(ValueError, match=match):
        srs.load_params_file(str(path), device="cpu", **kwargs)


def test_k11_file_commits_through_pippenger(tmp_path):
    """A k = 11 file (every point the generator, so it is cheap to build)
    loads with the Pippenger engine, and a sparse commitment equals
    (sum of the coefficients) * G."""
    k, n = 11, 1 << 11
    gen = srs._fq_raw(g.G1_GEN[0]) + srs._fq_raw(g.G1_GEN[1])
    s_g2 = pr.g2_scalar_mul(pr.G2_GEN, TAU)
    path = tmp_path / "params11"
    path.write_bytes(k.to_bytes(4, "little") + gen * (2 * n) + srs._g2_raw(pr.G2_GEN) + srs._g2_raw(s_g2))
    params = srs.load_params_file(str(path), k, device="cpu")
    assert isinstance(params.committer, PippengerMSM) and params.committer.n == n
    coeffs = [0] * n
    for i, v in ((0, 5), (1, FR_MOD - 1), (1000, 1 << 200), (n - 1, 12345)):
        coeffs[i] = v
    got = params.commit(ff.to_tensor(FR.encode_many(coeffs), "cpu"))
    assert group.to_affine_ints(got) == [g.scalar_mul(g.G1_GEN, sum(coeffs))]
