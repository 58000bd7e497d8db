"""The port's mesh layer (``zkevm_tpu_torch/parallel/mesh.py`` over gloo,
plain paths on CPU processes) against the reference's forced-host mesh
outputs recorded in ``tests/vectors/torch_port_mesh.json``: worlds of 2 and
4 ranks, spawned once each; field elements compared as integers (the same
canonical words), points by affine value. At world 2 the K=5 toy proof
with its commitments made through ``ParamsKZG.use_mesh`` equals the
reference proof of ``tests/vectors/torch_port_toy_proof.json`` field by
field. The ranks run ``tests/port/_mesh_worker.py``, which imports no JAX.
Also: the entry points that make tensors default to the card and raise
without one (``convert``, ``default_mesh``)."""

import fcntl
import json
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _mesh_worker
from zkevm_tpu_torch import convert
from zkevm_tpu_torch.ec import group
from zkevm_tpu_torch.kzg import ParamsKZG
from zkevm_tpu_torch.parallel import mesh as pm

WORLDS = (2, 4)
RANK_SECONDS = 300  # a hung collective fails the module instead of the run
NTT_KS = ("6", "7")
MSMS = ("sharded_msm", "sharded_msm_t_scan", "sharded_msm_t")


@pytest.fixture(scope="module")
def vectors():
    return json.loads(_mesh_worker.MESH_VECTORS.read_text())


def _spawn_worlds(base) -> dict:
    """{world: [rank 0's results, rank 1's, ...]}; both worlds run at once."""
    ctxs = {}
    for world in WORLDS:
        d = base / f"mesh{world}"
        d.mkdir()
        ctxs[world] = (d, mp.start_processes(_mesh_worker.run, args=(world, str(d / "store"), str(d)),
                                             nprocs=world, join=False, start_method="spawn"))
    deadline = time.monotonic() + RANK_SECONDS
    try:
        for _, ctx in ctxs.values():
            while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
                if time.monotonic() > deadline:
                    pytest.fail(f"the mesh ranks did not finish within {RANK_SECONDS} s")
    finally:
        for _, ctx in ctxs.values():
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
    return {str(world): [json.loads((d / f"rank{r}.json").read_text()) for r in range(world)]
            for world, (d, _) in ctxs.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The worlds' results, computed once per test run: under pytest-xdist
    the first worker to get here spawns the ranks and leaves the results in
    the run's shared temporary directory for the others."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        out = _spawn_worlds(tmp_path_factory.mktemp("mesh"))
    else:
        shared = tmp_path_factory.getbasetemp().parent
        with open(shared / "mesh_runs.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            done = shared / "mesh_runs.json"
            if not done.exists():
                base = shared / "mesh_runs"
                base.mkdir()
                done.write_text(json.dumps(_spawn_worlds(base)))
            out = json.loads(done.read_text())
    return {int(world): ranks for world, ranks in out.items()}


def _ref(vectors, world):
    return vectors["mesh_out"][str(world)]


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_whole_result(runs, world):
    ranks = runs[world]
    assert all(r == ranks[0] for r in ranks[1:])
    assert ranks[0]["collectives"]["all_to_all"] > 0 and ranks[0]["collectives"]["all_gather"] > 0


@pytest.mark.parametrize("direction", ["ntt", "intt"])
@pytest.mark.parametrize("k", NTT_KS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ntt_t_matches_reference(vectors, runs, world, k, direction):
    assert runs[world][0]["sharded_ntt_t"][k][direction] == _ref(vectors, world)["sharded_ntt_t"][k][direction]


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ntt_batch_matches_reference(vectors, runs, world):
    assert runs[world][0]["sharded_ntt_batch"] == _ref(vectors, world)["sharded_ntt_batch"]


@pytest.mark.parametrize("name", MSMS)
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_msms_match_reference(vectors, runs, world, name):
    assert runs[world][0][name] == _ref(vectors, world)[name]


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_msm_engine_matches_reference(vectors, runs, world):
    """MeshMSM (Pippenger, c = 4) gives the reference's sharded_msm_t point."""
    assert runs[world][0]["mesh_msm"] == _ref(vectors, world)["sharded_msm_t"]


@pytest.mark.parametrize("world", WORLDS)
def test_use_mesh_commit_matches_reference(vectors, runs, world):
    assert runs[world][0]["commit_scan"] == _ref(vectors, world)["commit_scan"]


def test_use_mesh_toy_proof_equals_reference(runs):
    ref = json.loads(_mesh_worker.TOY_VECTORS.read_text())["toy"]
    got = runs[_mesh_worker.TOY_WORLD][0]["toy"]
    assert got["fixed_commitments"] == ref["fixed_commitments"]
    assert got["sigma_commitments"] == ref["sigma_commitments"]
    for field in got["proof"]:
        assert got["proof"][field] == ref["proof"][field], field


def test_use_mesh_rejects_an_uneven_split():
    params = ParamsKZG(k=5, g1_powers=group.identity((32,), "cpu"), g2=None, s_g2=None)
    with pytest.raises(ValueError):
        params.use_mesh(pm.Mesh(None, 3, 0, "cpu"))


def test_default_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError):
        pm.default_mesh(device="cpu")


def test_mesh_msm_takes_only_n_by_8_scalars():
    engine = pm.MeshMSM(pm.Mesh(None, 1, 0, "cpu"), group.identity((4,), "cpu"))
    for bad in (torch.zeros(8, dtype=torch.int32), torch.zeros(1, 8, dtype=torch.int32),
                torch.zeros(4, 16, dtype=torch.int32)):
        with pytest.raises(ValueError):
            engine(bad)


@pytest.mark.parametrize("entry", ["limbs16_to_words", "params_from_numpy"])
def test_converters_default_to_the_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    limbs = np.zeros((4, 16), np.uint32)
    call = {"limbs16_to_words": lambda **kw: convert.limbs16_to_words(limbs, **kw),
            "params_from_numpy": lambda **kw: convert.params_from_numpy(limbs, limbs, limbs, None, None, **kw)}[entry]
    with pytest.raises(RuntimeError):
        call()
    assert call(device="cpu") is not None
