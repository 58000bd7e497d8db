"""Rank function of the gloo mesh tests (``tests/port/test_torch_mesh.py``).

It imports torch and the port only, so that the spawned ranks never import
JAX. Each rank joins a gloo process group through a file store, runs the
sharded functions of ``zkevm_tpu_torch/parallel/mesh.py`` on the inputs of
``tests/vectors/torch_port_mesh.json`` (at world 2 also the K=5 toy proof
with its commitments made through ``ParamsKZG.use_mesh``), and writes its
results as JSON to ``rank<r>.json`` in the output directory.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch
import torch.distributed as dist

from zkevm_tpu_torch.circuits import toy
from zkevm_tpu_torch.ec import goldens as g1g, group
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.field import FR
from zkevm_tpu_torch.kzg import ParamsKZG
from zkevm_tpu_torch.parallel import mesh as pm
from zkevm_tpu_torch.plonk import Assignment, ConstraintSystem, create_proof, keygen
from zkevm_tpu_torch.plonk.prover import _commit, proof_to_json

VECTORS = Path(__file__).resolve().parent.parent / "vectors"
MESH_VECTORS = VECTORS / "torch_port_mesh.json"
TOY_VECTORS = VECTORS / "torch_port_toy_proof.json"
TOY_WORLD = 2  # the world that also proves the toy circuit


def _enc(vals) -> torch.Tensor:
    return ff.to_tensor(FR.encode_many(vals), "cpu")


def _affine(p):
    q = group.to_affine_ints(p)[0]
    return None if q is None else [q[0], q[1]]


def compute(mesh: pm.Mesh) -> dict:
    vec = json.loads(MESH_VECTORS.read_text())
    out = {"sharded_ntt_t": {}}
    for k, vals in vec["sharded_ntt_t"].items():
        a = _enc(vals)
        out["sharded_ntt_t"][k] = {
            "ntt": FR.decode_many(pm.sharded_ntt_t(mesh, a, int(k))),
            "intt": FR.decode_many(pm.sharded_ntt_t(mesh, a, int(k), inverse=True)),
        }
    batch = vec["ntt_batch"]
    polys = torch.stack([_enc(p) for p in batch["polys"]])
    out["sharded_ntt_batch"] = [FR.decode_many(p) for p in pm.sharded_ntt_batch(mesh, polys, batch["k"])]
    m = vec["msm"]
    pts = group.from_affine_ints([None if p is None else tuple(p) for p in m["points"]], "cpu")
    sc = ff.to_tensor(ff.words_from_ints(m["scalars"]), "cpu")
    out["sharded_msm"] = _affine(pm.sharded_msm(mesh, pts, sc))
    out["sharded_msm_t_scan"] = _affine(pm.sharded_msm_t_scan(mesh, pts, sc))
    out["sharded_msm_t"] = _affine(pm.sharded_msm_t(mesh, pts, sc, c=m["c"]))
    out["mesh_msm"] = _affine(pm.MeshMSM(mesh, pts, c=m["c"])(sc))
    cm = vec["commit"]
    srs = [g1g.scalar_mul(g1g.G1_GEN, pow(cm["tau"], i, FR.modulus)) for i in range(1 << cm["k"])]
    params = ParamsKZG(k=cm["k"], g1_powers=group.from_affine_ints(srs, "cpu"), g2=None, s_g2=None)
    params.use_mesh(mesh, scan=True)
    out["commit_scan"] = list(_commit(params, _enc(cm["coeffs"])))
    if mesh.world == TOY_WORLD:
        tv = json.loads(TOY_VECTORS.read_text())
        params = ParamsKZG.unsafe_setup(tv["k"], tau=tv["tau"], device="cpu").use_mesh(mesh, scan=True)
        cs, cols = toy.build_toy(ConstraintSystem)
        asg = toy.assign_toy(cs, cols, Assignment)
        pk = keygen(params, cs, toy.fixed_only(cs, asg, Assignment))
        proof = create_proof(params, pk, [], asg, seed=tv["toy"]["seed"])
        out["toy"] = {"fixed_commitments": [list(p) for p in pk.vk.fixed_commitments],
                      "sigma_commitments": [list(p) for p in pk.vk.sigma_commitments],
                      "proof": proof_to_json(proof)}
    out["collectives"] = pm.collective_counts()
    return out


def run(rank: int, world: int, store: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        results = compute(pm.default_mesh(world, device="cpu"))
    finally:
        dist.destroy_process_group()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(results))
