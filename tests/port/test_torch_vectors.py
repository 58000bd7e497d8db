"""The recorded reference vectors, which the port's tests and
``chip_smoke.py`` compare against, still equal what
``scripts/record_torch_vectors.py`` produces from the JAX package: the toy
proofs (``tests/vectors/torch_port_toy_proof.json``) recorded again in full;
of the state-trie case (``tests/vectors/torch_port_mpt.json``) the host
parts, recorded again, with the digests that bind the slow parts to them;
of the KZG vector (``tests/vectors/torch_port_kzg.json``) the inputs, made
again, with the digests that bind the reference's SRS files, ``msm_t``
results and opening to them; of the mesh vector
(``tests/vectors/torch_port_mesh.json``) the inputs, made again, with the
digests that bind the reference's ``ntt_t`` and forced-host mesh outputs to
them; of the lazy-13 vector (``tests/vectors/torch_port_l13.json``) the
inputs, made again, with the digests that bind the reference's point
formulas, ``msm13`` window sums and results and ``Msm13`` conversion to
them; of the quotient vector (``tests/vectors/torch_port_quotient.json``)
the inputs, made again, with the digests that bind the reference's folded
parts to them."""

import importlib.util
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(scope="module")
def rec():
    spec = importlib.util.spec_from_file_location(
        "record_torch_vectors", ROOT / "scripts" / "record_torch_vectors.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_vector_file_is_current(rec):
    assert json.loads(rec.OUT.read_text()) == rec.record()


def test_mpt_vector_file_is_current(rec):
    vec = json.loads(rec.MPT_OUT.read_text())
    host, _ = rec.record_mpt_host()
    assert {key: vec[key] for key in rec.MPT_HOST_KEYS} == host
    assert vec["inputs_digest"] == rec.sha256_json(host)
    outputs = {key: vec[key] for key in vec
               if key not in rec.MPT_HOST_KEYS + ("inputs_digest", "outputs_digest")}
    assert vec["outputs_digest"] == rec.sha256_json(outputs)
    states, msgs = rec.poseidon_inputs()
    assert vec["poseidon"]["states"] == states and vec["poseidon"]["messages"] == msgs


def test_kzg_vector_file_is_current(rec):
    vec = json.loads(rec.KZG_OUT.read_text())
    host = rec.kzg_inputs()
    assert {key: vec[key] for key in rec.KZG_HOST_KEYS} == host
    assert vec["inputs_digest"] == rec.sha256_json(host)
    outputs = {key: vec[key] for key in vec
               if key not in rec.KZG_HOST_KEYS + ("inputs_digest", "outputs_digest")}
    assert vec["outputs_digest"] == rec.sha256_json(outputs)


def test_mesh_vector_file_is_current(rec):
    vec = json.loads(rec.MESH_OUT.read_text())
    host = rec.mesh_inputs()
    assert {key: vec[key] for key in rec.MESH_HOST_KEYS} == host
    assert vec["inputs_digest"] == rec.sha256_json(host)
    outputs = {key: vec[key] for key in vec
               if key not in rec.MESH_HOST_KEYS + ("inputs_digest", "outputs_digest")}
    assert vec["outputs_digest"] == rec.sha256_json(outputs)
    assert set(vec["mesh_out"]) == {str(w) for w in rec.MESH_WORLDS}


def test_l13_vector_file_is_current(rec):
    vec = json.loads(rec.L13_OUT.read_text())
    host = rec.l13_inputs()
    assert {key: vec[key] for key in rec.L13_HOST_KEYS} == host
    assert vec["inputs_digest"] == rec.sha256_json(host)
    outputs = {key: vec[key] for key in vec
               if key not in rec.L13_HOST_KEYS + ("inputs_digest", "outputs_digest")}
    assert set(outputs) == {f"{key}_out" for key in rec.L13_HOST_KEYS}
    assert vec["outputs_digest"] == rec.sha256_json(outputs)
    assert [len(case["windows"]["inf"]) for case in vec["msm_out"]] == [64, 64, 16]


def test_quotient_vector_file_is_current(rec):
    vec = json.loads(rec.QUOTIENT_OUT.read_text())
    host = rec.quotient_host()
    assert {key: vec[key] for key in rec.QUOTIENT_RECORDED} == host
    assert vec["inputs_digest"] == rec.sha256_json(host)
    outputs = {key: vec[key] for key in vec
               if key not in rec.QUOTIENT_RECORDED + ("inputs_digest", "outputs_digest")}
    assert set(outputs) == {f"{key}_fold" for key in rec.QUOTIENT_RECORDED}
    assert vec["outputs_digest"] == rec.sha256_json(outputs)
    assert all(len(fold) == 1 << rec.QUOTIENT_K for fold in outputs.values())
