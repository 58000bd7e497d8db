"""Record reference vectors from the JAX package for the PyTorch port.

Usage: python scripts/record_torch_vectors.py [toy|mpt|kzg|mesh|l13|quotient ...]

Runs ``zkevm_tpu`` on the CPU and writes six files (all by default).

``tests/vectors/torch_port_toy_proof.json``: for the K=5 toy circuit of
``tests/test_plonk.py`` and for a two-phase toy circuit with one
challenge (both from ``zkevm_tpu_torch/circuits/toy.py``, built with the
reference's own classes), the SRS tau, the instances, the blinding seed,
the verifying key's commitments and every field of the ``Proof``.
``chip_smoke.py`` holds the GPU port's proofs against this file (the GPU
machine has no JAX), and ``tests/port/test_torch_vectors.py`` checks that the
file still equals what this script produces.

``tests/vectors/torch_port_mpt.json``: the small state-trie case of
``zkevm_tpu_torch/circuits/mpt_small.py`` (the MPT circuit over the
PoseidonTable at depth 8, k=12, two chained updates). Its host parts are
cheap to record again (the trie roots and key hashes, a digest of the
Poseidon states the lookups need and of the whole witness); the rest is
not: the JAX ``permute`` and ``hash_many`` on fixed inputs, the
MockProver's failure lists for the honest witness and the four tampered
ones, the verifying key and its fingerprint, and the proof under a
``PoseidonTranscript``. ``inputs_digest`` binds those to the host parts
they were made from, and ``outputs_digest`` to their recorded values, so
that ``tests/port/test_torch_vectors.py`` can hold the file to the
reference by recording the host parts again.

``tests/vectors/torch_port_kzg.json``: the SRS-file path and the KZG layer.
Its inputs are cheap to make again from fixed seeds (the SRS degrees and
tau; 96 points, among them the identity and a repeated base, and 96 scalars
with zeros, 2^255, 2^256 - 1 and r - 1; the MSM cases; a K=4 polynomial and
an opening point); its outputs are the reference's: the bytes of the
halo2-layout files ``write_params_file`` writes for ``unsafe_setup(k,
tau=777)`` at k = 4 and 6, the affine results of ``ec/pippenger.py``
``msm_t`` for each case, and ``open_single``'s value and proof with the
polynomial's commitment. ``inputs_digest`` and ``outputs_digest`` bind them
as in the MPT file.

``tests/vectors/torch_port_mesh.json``: the four-step NTT and the mesh
layer. Its inputs are made from fixed seeds (field elements for
``poly/ntt.py`` ``ntt_t`` / ``intt_t`` at k = 8 and 9, for
``parallel/mesh.py`` ``sharded_ntt_t`` at k = 6 and 7 and for
``sharded_ntt_batch`` over 4 polynomials at k = 5; 32 points, among them the
identity and a repeated base, with 32 scalars; a k = 5 SRS of tau 777 and a
polynomial to commit). Its outputs are the reference's: ``ntt_t`` and
``intt_t`` (normal XLA:CPU), and, on forced-host meshes of 2 and 4 CPU
devices, ``sharded_ntt_t`` forward and inverse (``unroll=False``),
``sharded_ntt_batch``, ``sharded_msm``, ``sharded_msm_t_scan``,
``sharded_msm_t`` (c = 4) and the prover's ``_commit`` after
``use_mesh(mesh, scan=True)``. The forced-host part runs in a subprocess
with ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and a JAX cache
of its own under ``build/`` (that mode's cache entries must not reach a
normal process). ``inputs_digest`` and ``outputs_digest`` bind them as in
the MPT file.

``tests/vectors/torch_port_l13.json``: the lazy-13 point formulas and MSM
(``ec/msm13.py``). Its inputs are made from fixed seeds: lazy Jacobian
points (13-bit limbs of x + m*p for small m, so not canonical) for
``add_l``, ``double_l`` and ``madd_l``, with lanes at the identity, equal
and opposite points, each formula once on lanes that raise no doubling
flag and once with a lane that does; the bases and scalars of
``tests/test_msm13.py`` at (n, c, lanes, wgroup) = (16, 4, 4, 32),
(64, 4, 8, 64) and (16, 16, 4, 4); and a 16-point SRS (``unsafe_setup(4,
tau=777)``). Its outputs are the reference's lazy words and flags: each
formula's result, each MSM's window sums per window group and its Horner
result, and ``Msm13``'s ``ax13`` / ``ay13`` of the SRS. The reference runs
in a subprocess with a JAX cache of its own under ``build/``, its MSMs
under ``jax.disable_jit()`` (compiled, ``_window_sums`` takes tens of GB of
XLA:CPU memory; eager, about 20 minutes each and little memory: the same
integer ops). ``inputs_digest`` and ``outputs_digest`` bind them as in the
MPT file.

``tests/vectors/torch_port_quotient.json``: one part of the quotient's
numerator over the KeccakTable and the depth-8 MPT constraint lists at 16
rows. Its inputs are made from fixed seeds (the protocol's challenges, the
circuits' challenges, y, the order of the columns the constraints query;
their values and the domain points come from ``quotient_values``); its
outputs are the reference's ``_h_part`` fold, evaluated by the reference's
``Expr.evaluate`` and ``EvalContext``. ``inputs_digest`` and
``outputs_digest`` bind them as in the MPT file.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "vectors" / "torch_port_toy_proof.json"
MPT_OUT = ROOT / "tests" / "vectors" / "torch_port_mpt.json"
MPT_HOST_KEYS = ("depth", "k", "roots", "key_hashes", "states_digest", "witness_digest")
KZG_OUT = ROOT / "tests" / "vectors" / "torch_port_kzg.json"
KZG_HOST_KEYS = ("srs", "msm", "open")
SRS_TAU = 777  # scripts/gen_srs.py's tau
SRS_KS = (4, 6)
MSM_POINTS = 96
# (n, c, signed, sublanes): every window width and digit kind at n = 64 (one
# step per lane), and n = 96 with 64 sublanes, where Lw halves to 32
MSM_CASES = [(64, c, signed, 1024) for c in (3, 4, 5) for signed in (False, True)] + [
    (96, 4, False, 64), (96, 4, True, 64)]
OPEN_K = 4
OPEN_TAU = 0xACE0FBA5E  # tests/test_kzg.py's
OPEN_Z = 987654321987654321
MESH_OUT = ROOT / "tests" / "vectors" / "torch_port_mesh.json"
MESH_HOST_KEYS = ("ntt_t", "sharded_ntt_t", "ntt_batch", "msm", "commit", "worlds")
MESH_WORLDS = (2, 4)
MESH_POINTS = 32
NTT_T_KS = (8, 9)
SHARDED_NTT_T_KS = (6, 7)  # __graft_entry__.py's multichip dry-run size, and one with k1 != k2
NTT_BATCH = (4, 5)  # polynomials, k
MESH_MSM_C = 4
COMMIT_K = 5  # the dryrun's commit stage
FORCED_HOST_CACHE = ROOT / "build" / "jax_cache_forced_host"
L13_OUT = ROOT / "tests" / "vectors" / "torch_port_l13.json"
L13_HOST_KEYS = ("ops", "msm", "srs")
L13_CACHE = ROOT / "build" / "jax_cache_l13"
L13_MSM_CASES = ((16, 4, 4, 32), (64, 4, 8, 64), (16, 16, 4, 4))  # tests/test_msm13.py's shapes
L13_SRS = (4, 777)  # k, tau
HASH_LENGTHS = (1, 2, 3, 5)
TAU = 0xDEAD_BEEF_CAFE  # the reference's default unsafe_setup tau
TOY_SEED = 7
TWO_PHASE_SEED = 11
QUOTIENT_OUT = ROOT / "tests" / "vectors" / "torch_port_quotient.json"
QUOTIENT_K = 4  # 16 rows: every rotation of these circuits wraps somewhere
QUOTIENT_RECORDED = ("keccak_table", "mpt")  # the live checks (toy, two_phase) are cheap


def record() -> dict:
    """Prove both toy circuits with the JAX package; return the vectors."""
    sys.path.insert(0, str(ROOT))
    from zkevm_tpu.kzg import ParamsKZG
    from zkevm_tpu.plonk import Assignment, ConstraintSystem, create_proof, keygen
    from zkevm_tpu_torch.circuits import toy
    from zkevm_tpu_torch.plonk.prover import proof_to_json

    def _pt(p):
        return None if p is None else [int(p[0]), int(p[1])]

    params = ParamsKZG.unsafe_setup(toy.K, tau=TAU, windowed=False)
    out = {"k": toy.K, "tau": TAU}

    cs, cols = toy.build_toy(ConstraintSystem)
    asg = toy.assign_toy(cs, cols, Assignment)
    pk = keygen(params, cs, toy.fixed_only(cs, asg, Assignment))
    proof = create_proof(params, pk, [], asg, seed=TOY_SEED)
    out["toy"] = {
        "seed": TOY_SEED,
        "instances": [],
        "fixed_commitments": [_pt(p) for p in pk.vk.fixed_commitments],
        "sigma_commitments": [_pt(p) for p in pk.vk.sigma_commitments],
        "proof": proof_to_json(proof),
    }

    cs, cols = toy.build_two_phase(ConstraintSystem)
    fixed, witness = toy.two_phase_witness(cs, cols, Assignment)
    pk = keygen(params, cs, fixed)
    proof = create_proof(params, pk, [], witness, seed=TWO_PHASE_SEED)
    out["two_phase"] = {
        "seed": TWO_PHASE_SEED,
        "instances": [],
        "fixed_commitments": [_pt(p) for p in pk.vk.fixed_commitments],
        "sigma_commitments": [_pt(p) for p in pk.vk.sigma_commitments],
        "proof": proof_to_json(proof),
    }
    return out


def progress(msg: str) -> None:
    print(f"record_torch_vectors: {msg}", file=sys.stderr, flush=True)


def sha256_json(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def record_mpt_host():
    """The reference's host parts of the small state-trie case: -> (the
    vector's host entries, (cs, PoseidonTable config, MPT config,
    assignment))."""
    sys.path.insert(0, str(ROOT))
    from zkevm_tpu.circuits import mpt_circuit as jmpt, poseidon_table as jpt
    from zkevm_tpu.plonk import Assignment, ConstraintSystem
    from zkevm_tpu.state.zktrie import ZkTrie
    from zkevm_tpu_torch import convert
    from zkevm_tpu_torch.circuits import mpt_circuit, mpt_small as ms, poseidon_table
    from zkevm_tpu_torch.plonk import ConstraintSystem as PortConstraintSystem

    cs, ptcfg, mcfg = ms.build(ConstraintSystem, jpt, jmpt)
    ups = ms.updates(ZkTrie, jmpt)
    states = jmpt.poseidon_states(ups, ms.DEPTH)
    asg = Assignment(cs, ms.N)
    jpt.assign(cs, ptcfg, ms.N, states, asg)
    jmpt.assign(cs, mcfg, ms.N, ups, asg)
    port_cs = ms.build(PortConstraintSystem, poseidon_table, mpt_circuit)[0]
    host = {
        "depth": ms.DEPTH,
        "k": ms.K,
        "roots": [[u.root_old, u.root_new] for u in ups],
        "key_hashes": [u.kh for u in ups],
        "states_digest": sha256_json(states),
        "witness_digest": convert.assignment_from_reference(asg, port_cs).digest(),
    }
    return host, (cs, ptcfg, mcfg, asg)


def poseidon_inputs():
    """Fixed inputs of the recorded JAX permute / hash_many outputs: eight
    states (0, 1 and p - 1 among their elements) and, for each length L in
    HASH_LENGTHS, four messages."""
    from zkevm_tpu_torch.ff.goldens import FR_MOD

    rng = np.random.default_rng(19)

    def elems(count):
        return [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(count)]

    states = [[0, 0, 0], [1, 2, 3], [FR_MOD - 1, FR_MOD - 1, FR_MOD - 1]]
    states += [elems(3) for _ in range(5)]
    msgs = {str(n): [elems(n) for _ in range(4)] for n in HASH_LENGTHS}
    return states, msgs


class _JaxWithoutJit:
    """``jax`` as the reference prover sees it, with ``jit`` the identity."""

    def __init__(self, jax):
        self._jax = jax

    def __getattr__(self, name):
        return self._jax.__getattribute__(name)

    @staticmethod
    def jit(fn, *args, **kwargs):
        return fn


@contextlib.contextmanager
def _eager_quotient():
    """Run the reference prover's quotient (``jax.jit(_h_part)``, one XLA
    program over every constraint, which XLA:CPU compiles for most of an
    hour in tens of GB at this circuit's size) op by op: the field ops it
    calls stay jitted one by one, and integer results do not depend on
    how the graph is compiled."""
    from zkevm_tpu.plonk import prover as jprover

    real = jprover.jax
    jprover.jax = _JaxWithoutJit(real)
    try:
        yield
    finally:
        jprover.jax = real


def record_mpt() -> dict:
    """The whole MPT vector (slow: the JAX MockProver, keygen and prover)."""
    sys.path.insert(0, str(ROOT))
    import jax.numpy as jnp

    from zkevm_tpu.ec.msm import FixedBaseMSM
    from zkevm_tpu.ff import FR
    from zkevm_tpu.hash import poseidon as jpos
    from zkevm_tpu.kzg import ParamsKZG
    from zkevm_tpu.plonk import MockProver, create_proof, keygen
    from zkevm_tpu.plonk.verifier import verify_proof
    from zkevm_tpu.prover.artifacts import vk_fingerprint
    from zkevm_tpu.transcript import PoseidonTranscript
    from zkevm_tpu_torch.circuits import mpt_small as ms
    from zkevm_tpu_torch.plonk.prover import proof_to_json

    host, (cs, ptcfg, mcfg, asg) = record_mpt_host()
    spec = jpos.P128_POW5_T3
    states, msgs = poseidon_inputs()
    enc = np.stack([np.stack([FR.encode(v) for v in s]) for s in states])
    permuted = np.asarray(jpos.permute(spec, jnp.asarray(enc)))
    hashes = {}
    for length, group in msgs.items():
        m = np.stack([np.stack([FR.encode(v) for v in msg]) for msg in group])
        hashes[length] = [FR.decode(d) for d in np.asarray(jpos.hash_many(spec, m))]

    progress("MPT: poseidon vectors recorded")
    mock = {"honest": ms.failures_to_json(MockProver(cs, asg).verify())}
    for name, tamper in ms.TAMPERS.items():
        bad = type(asg)(cs, asg.n)
        bad.cols = {c: a.copy() for c, a in asg.cols.items()}
        tamper(bad, mcfg, ms.DEPTH)
        mock[name] = ms.failures_to_json(MockProver(cs, bad).verify())

    progress("MPT: MockProver lists recorded")
    params = ParamsKZG.unsafe_setup(ms.K, tau=TAU, windowed=False)
    # above k=10 unsafe_setup picks the prefix-sum MSM, whose c=16 tables
    # take ~35 GB and most of an hour to compile on the CPU; the windowed
    # fixed-base engine gives the same commitments at this size
    params.pippenger, params.committer = None, FixedBaseMSM(params.g1_powers)
    pk = keygen(params, cs, asg)
    progress("MPT: keygen done")
    with _eager_quotient():
        proof = create_proof(params, pk, [], asg, seed=ms.SEED, transcript=PoseidonTranscript())
    progress("MPT: proof done")
    if not verify_proof(params, pk.vk, [], proof, transcript=PoseidonTranscript()):
        raise RuntimeError("the reference rejects its own MPT proof")
    outputs = {
        "poseidon": {
            "states": states,
            "permute": [[FR.decode(v) for v in s] for s in permuted],
            "messages": msgs,
            "hash_many": hashes,
        },
        "mock": mock,
        "tau": TAU,
        "seed": ms.SEED,
        "fixed_commitments": [[int(p[0]), int(p[1])] for p in pk.vk.fixed_commitments],
        "vk_fingerprint": vk_fingerprint(pk.vk),
        "proof": proof_to_json(proof),
    }
    return {**host, "inputs_digest": sha256_json(host), **outputs,
            "outputs_digest": sha256_json(outputs)}


def kzg_inputs() -> dict:
    """The cheap inputs of the KZG vector, made from fixed seeds."""
    from zkevm_tpu_torch.ec import goldens as g1g
    from zkevm_tpu_torch.ff.goldens import FR_MOD

    rng = np.random.default_rng(23)
    pts = [list(g1g.random_point(rng)) for _ in range(MSM_POINTS)]
    scalars = [int.from_bytes(rng.bytes(32), "little") for _ in range(MSM_POINTS)]
    pts[1] = None  # the identity
    pts[5] = pts[6] = pts[4]  # a repeated base; with an equal scalar, the doubling case
    scalars[5] = scalars[4]
    scalars[0] = scalars[70] = 0
    scalars[7], scalars[8], scalars[9] = (1 << 256) - 1, 1 << 255, FR_MOD - 1
    coeffs = [int(v) for v in np.random.default_rng(29).integers(0, 1 << 62, 1 << OPEN_K)]
    return {
        "srs": {"tau": SRS_TAU, "ks": list(SRS_KS)},
        "msm": {"points": pts, "scalars": scalars,
                "cases": [{"n": n, "c": c, "signed": sg, "sublanes": sub} for n, c, sg, sub in MSM_CASES]},
        "open": {"k": OPEN_K, "tau": OPEN_TAU, "coeffs": coeffs, "z": OPEN_Z},
    }


def record_kzg() -> dict:
    """The KZG vector: the reference's SRS files, msm_t results and opening
    (slow: a JAX compile for each MSM geometry)."""
    import tempfile

    sys.path.insert(0, str(ROOT))
    from zkevm_tpu.ec import group, group_t
    from zkevm_tpu.ec.pippenger import msm_t
    from zkevm_tpu.ff import FR, limbs
    from zkevm_tpu.kzg import ParamsKZG, open_single
    from zkevm_tpu.kzg.srs import write_params_file
    from zkevm_tpu.poly import ntt as nttmod

    def _pt(p):
        return None if p is None else [int(p[0]), int(p[1])]

    host = kzg_inputs()
    files = {}
    with tempfile.TemporaryDirectory() as tmp:
        for k in SRS_KS:
            path = os.path.join(tmp, f"params{k}")
            write_params_file(ParamsKZG.unsafe_setup(k, tau=SRS_TAU, windowed=False), path, tau=SRS_TAU)
            files[str(k)] = Path(path).read_bytes().hex()
    progress("KZG: SRS files recorded")
    m = host["msm"]
    results = []
    for case in m["cases"]:
        n = case["n"]
        pts = group_t.from_g1(group.from_affine_ints([None if p is None else tuple(p) for p in m["points"][:n]]))
        out = msm_t(pts, limbs.limbs_from_ints(m["scalars"][:n]), c=case["c"], sublanes=case["sublanes"],
                    signed=case["signed"])
        results.append(_pt(group.to_affine_ints(group_t.to_g1(out))[0]))
        progress(f"KZG: msm_t {case} recorded")
    op = host["open"]
    params = ParamsKZG.unsafe_setup(op["k"], op["tau"])
    enc = np.stack([FR.encode(c) for c in op["coeffs"]])
    value, proof = open_single(params, nttmod.ntt(enc, op["k"]), op["z"])
    outputs = {
        "srs_files": files,
        "msm_results": results,
        "open_result": {"value": int(value), "proof": _pt(group.to_affine_ints(proof)[0]),
                        "commitment": _pt(group.to_affine_ints(params.commit(enc))[0])},
    }
    return {**host, "inputs_digest": sha256_json(host), **outputs, "outputs_digest": sha256_json(outputs)}


def mesh_inputs() -> dict:
    """The cheap inputs of the mesh vector, made from fixed seeds."""
    from zkevm_tpu_torch.ec import goldens as g1g
    from zkevm_tpu_torch.ff.goldens import FR_MOD

    rng = np.random.default_rng(31)

    def elems(count):
        return [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(count)]

    pts = [list(g1g.random_point(rng)) for _ in range(MESH_POINTS)]
    scalars = [int.from_bytes(rng.bytes(32), "little") for _ in range(MESH_POINTS)]
    pts[1] = None  # the identity
    pts[5] = pts[4]  # a repeated base with an equal scalar: the doubling case
    scalars[5] = scalars[4]
    scalars[0], scalars[7], scalars[9] = 0, (1 << 256) - 1, FR_MOD - 1
    nb, kb = NTT_BATCH
    return {
        "ntt_t": {str(k): elems(1 << k) for k in NTT_T_KS},
        "sharded_ntt_t": {str(k): elems(1 << k) for k in SHARDED_NTT_T_KS},
        "ntt_batch": {"k": kb, "polys": [elems(1 << kb) for _ in range(nb)]},
        "msm": {"points": pts, "scalars": scalars, "c": MESH_MSM_C},
        "commit": {"k": COMMIT_K, "tau": SRS_TAU, "coeffs": elems(1 << COMMIT_K)},
        "worlds": list(MESH_WORLDS),
    }


def _mesh_forced_host(host: dict) -> dict:
    """The reference's mesh functions on forced-host meshes of each world
    size (run in a process started with XLA's forced host device count)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_compilation_cache_dir", str(FORCED_HOST_CACHE))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    sys.path.insert(0, str(ROOT))
    from zkevm_tpu.ec import goldens as g1g, group, group_t
    from zkevm_tpu.ec.group import G1
    from zkevm_tpu.ff import FR, limbs
    from zkevm_tpu.kzg.params import ParamsKZG
    from zkevm_tpu.parallel import mesh as meshmod
    from zkevm_tpu.plonk.prover import _commit

    def enc(vals):
        return np.stack([FR.encode(v) for v in vals])

    def dec(a):
        return [FR.decode(v) for v in np.asarray(a).reshape(-1, limbs.L)]

    def aff(p):
        q = group.to_affine_ints(G1(*(jnp.reshape(c, (1, limbs.L)) for c in p)))[0]
        return None if q is None else [int(q[0]), int(q[1])]

    def aff_t(p):
        return aff(group_t.to_g1(p))

    m = host["msm"]
    pts = group.from_affine_ints([None if p is None else tuple(p) for p in m["points"]])
    sc = jnp.asarray(limbs.limbs_from_ints(m["scalars"]))
    cm = host["commit"]
    srs, t = [], 1
    for _ in range(1 << cm["k"]):
        srs.append(g1g.scalar_mul(g1g.G1_GEN, t))
        t = t * cm["tau"] % FR.modulus
    out = {}
    for world in host["worlds"]:
        mesh = meshmod.default_mesh(world)
        if mesh.shape["chips"] != world:
            raise RuntimeError(f"forced-host mesh has {mesh.shape['chips']} devices, not {world}")
        r = {"sharded_ntt_t": {}}
        for k, vals in host["sharded_ntt_t"].items():
            a_t = jnp.asarray(enc(vals).T)
            r["sharded_ntt_t"][k] = {
                "ntt": dec(meshmod.sharded_ntt_t(mesh, a_t, int(k), unroll=False).T),
                "intt": dec(meshmod.sharded_ntt_t(mesh, a_t, int(k), inverse=True, unroll=False).T),
            }
            progress(f"mesh: world {world} sharded_ntt_t k={k} recorded")
        b = host["ntt_batch"]
        polys = jnp.asarray(np.stack([enc(p) for p in b["polys"]]))
        got = np.asarray(meshmod.sharded_ntt_batch(mesh, polys, b["k"]))
        r["sharded_ntt_batch"] = [dec(p) for p in got]
        progress(f"mesh: world {world} sharded_ntt_batch recorded")
        r["sharded_msm_t_scan"] = aff_t(meshmod.sharded_msm_t_scan(mesh, group_t.from_g1(pts), sc))
        progress(f"mesh: world {world} sharded_msm_t_scan recorded")
        params = ParamsKZG(k=cm["k"], g1_powers=group.from_affine_ints(srs), g2=None, s_g2=None)
        params.use_mesh(mesh, scan=True)
        c = _commit(params, jnp.asarray(enc(cm["coeffs"])))
        r["commit_scan"] = None if c is None else [int(c[0]), int(c[1])]
        progress(f"mesh: world {world} use_mesh commit recorded")
        r["sharded_msm"] = aff(meshmod.sharded_msm(mesh, pts, sc))
        progress(f"mesh: world {world} sharded_msm recorded")
        r["sharded_msm_t"] = aff_t(meshmod.sharded_msm_t(mesh, group_t.from_g1(pts), sc, c=m["c"]))
        progress(f"mesh: world {world} sharded_msm_t recorded")
        out[str(world)] = r
    return out


def record_mesh() -> dict:
    """The mesh vector: the reference's ntt_t / intt_t here, and its mesh
    functions in a forced-host subprocess (slow: minutes of compilation)."""
    sys.path.insert(0, str(ROOT))
    import jax.numpy as jnp

    from zkevm_tpu.ff import FR
    from zkevm_tpu.poly import ntt as nttmod

    host = mesh_inputs()
    ntt_t = {}
    for k, vals in host["ntt_t"].items():
        a_t = jnp.asarray(np.stack([FR.encode(v) for v in vals]).T)
        ntt_t[k] = {"ntt": [FR.decode(v) for v in np.asarray(nttmod.ntt_t(a_t, int(k))).T],
                    "intt": [FR.decode(v) for v in np.asarray(nttmod.intt_t(a_t, int(k))).T]}
        progress(f"mesh: ntt_t k={k} recorded")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + f" --xla_force_host_platform_device_count={max(MESH_WORLDS)}").strip())
    proc = subprocess.run([sys.executable, __file__, "mesh-forced-host"], input=json.dumps(host),
                          capture_output=True, text=True, env=env, cwd=ROOT, check=False)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"the forced-host mesh recording failed (rc {proc.returncode})")
    outputs = {"ntt_t_out": ntt_t, "mesh_out": json.loads(proc.stdout.strip().splitlines()[-1])}
    return {**host, "inputs_digest": sha256_json(host), **outputs, "outputs_digest": sha256_json(outputs)}


def _limbs13(v: int) -> list[int]:
    return [(v >> (13 * i)) & 0x1FFF for i in range(21)]


def l13_inputs() -> dict:
    """The cheap inputs of the lazy-13 vector, made from fixed seeds. A
    point lane is [x, y, z, inf] with each coordinate as 21 13-bit limbs of
    a lazy value v + m*q < 2^263 (strict limbs, value not reduced)."""
    sys.path.insert(0, str(ROOT))
    from zkevm_tpu_torch.ec import goldens as g1g
    from zkevm_tpu_torch.ff.goldens import FQ_MOD, FR_MOD

    rng = np.random.default_rng(37)
    q = FQ_MOD

    def lazy(v):
        return _limbs13(v % q + int(rng.integers(0, 400)) * q)

    def jac(pt):
        """Affine (x, y) or None -> a Jacobian lane with a random z."""
        if pt is None:
            return [_limbs13(1), _limbs13(1), _limbs13(0), True]
        z = int(rng.integers(1, 1 << 62)) ** 4 % q
        return [lazy(pt[0] * z * z), lazy(pt[1] * z * z * z), lazy(z), False]

    def affine(pt):
        return [lazy(pt[0]), lazy(pt[1])]

    pts = [g1g.random_point(rng) for _ in range(8)]
    others = [g1g.random_point(rng) for _ in range(8)]
    # add_l lanes: 0-3 generic, 4 p = identity, 5 q = identity, 6 both, 7 q = -p
    ap = [pts[0], pts[1], pts[2], pts[3], None, pts[5], None, pts[7]]
    aq = [others[0], others[1], others[2], others[3], others[4], None, None, g1g.neg(pts[7])]
    # and a call with a doubling lane (2: q = p in another z)
    dp = [pts[0], pts[1], pts[2], pts[3]]
    dq = [others[0], others[1], pts[2], others[3]]
    # madd_l lanes: 0-3 generic, 4 acc = identity, 5 leaf = -acc; then a
    # call whose lane 1 has leaf = acc
    mp = [pts[0], pts[1], pts[2], pts[3], None, pts[5]]
    mq = [others[0], others[1], others[2], others[3], others[4], g1g.neg(pts[5])]
    mp2 = [pts[0], pts[1], pts[2]]
    mq2 = [others[0], pts[1], others[2]]
    ops = {
        "add": {"p": [jac(v) for v in ap], "q": [jac(v) for v in aq]},
        "add_dbl": {"p": [jac(v) for v in dp], "q": [jac(v) for v in dq]},
        "double": {"p": [jac(v) for v in ap]},
        "madd": {"p": [jac(v) for v in mp], "q": [affine(v) for v in mq]},
        "madd_dbl": {"p": [jac(v) for v in mp2], "q": [affine(v) for v in mq2]},
    }
    msm = []
    for n, c, lanes, wgroup in L13_MSM_CASES:
        r = np.random.default_rng(7)  # tests/test_msm13.py's bases and scalars
        base_ks = [int(r.integers(1, 1 << 60)) for _ in range(n)]
        scal = [int.from_bytes(r.bytes(31), "little") % FR_MOD for _ in range(n)]
        scal[0], scal[1] = 0, FR_MOD - 1
        msm.append({"n": n, "c": c, "lanes": lanes, "wgroup": wgroup,
                    "points": [list(g1g.scalar_mul(g1g.G1_GEN, k)) for k in base_ks], "scalars": scal})
    return {"ops": ops, "msm": msm, "srs": {"k": L13_SRS[0], "tau": L13_SRS[1]}}


def _l13_reference(host: dict) -> dict:
    """The reference's lazy-13 outputs on ``host`` (run in a subprocess
    with a JAX cache of its own)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_compilation_cache_dir", str(L13_CACHE))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    sys.path.insert(0, str(ROOT))
    from zkevm_tpu.ec import group, group_t, msm13 as rm
    from zkevm_tpu.ff import limbs
    from zkevm_tpu.kzg import ParamsKZG

    def words(a):
        return np.asarray(a, dtype=np.uint32).T.astype(int).tolist()  # (21, B) -> B lists of 21

    def g1l(lanes):
        coords = [jnp.asarray(np.array([ln[i] for ln in lanes], dtype=np.uint32).T) for i in range(3)]
        return rm.G1L(*coords, jnp.asarray(np.array([ln[3] for ln in lanes], dtype=bool)))

    def lanes_of(p):
        return {"x": words(p.x), "y": words(p.y), "z": words(p.z),
                "inf": [bool(v) for v in np.asarray(p.inf)]}

    out = {"ops": {}}
    for name, case in host["ops"].items():
        p = g1l(case["p"])
        if name.startswith("add"):
            r, f = rm.add_l(p, g1l(case["q"]))
        elif name == "double":
            r, f = rm.double_l(p), None
        else:
            qx = jnp.asarray(np.array([ln[0] for ln in case["q"]], dtype=np.uint32).T)
            qy = jnp.asarray(np.array([ln[1] for ln in case["q"]], dtype=np.uint32).T)
            r, f = rm.madd_l(p, qx, qy)
        out["ops"][name] = {**lanes_of(r), "flag": None if f is None else int(np.asarray(f))}
        progress(f"l13: {name} recorded")
    out["msm"] = []
    with jax.disable_jit():
        for case in host["msm"]:
            n, c, lanes, wgroup = case["n"], case["c"], case["lanes"], case["wgroup"]
            pts = group_t.from_g1(group.from_affine_ints([tuple(p) for p in case["points"]]))
            eng = rm.Msm13(pts, c=c, lanes=lanes, wgroup=wgroup)
            scalars = jnp.asarray(limbs.limbs_from_ints(case["scalars"]), jnp.uint32)
            # msm13's own steps, with the window sums of each group kept
            W = (254 + c - 1) // c
            lw = min(lanes, n)
            while n % lw:
                lw //= 2
            digits = jnp.stack([limbs.scalar_window(scalars, w, c) for w in range(W)])
            iota = jnp.broadcast_to(jnp.arange(n, dtype=jnp.uint32)[None], (W, n))
            sd, perm = jax.lax.sort((digits, iota), dimension=1, num_keys=1)
            groups, gx, gy, gz, gi = [], [], [], [], []
            for g0 in range(0, W, wgroup):
                g1 = min(g0 + wgroup, W)
                pg = perm[g0:g1].reshape(-1)
                px = jnp.take(eng.ax13, pg, axis=1).reshape(21, g1 - g0, lw, n // lw)
                py = jnp.take(eng.ay13, pg, axis=1).reshape(21, g1 - g0, lw, n // lw)
                x, y, z, inf, f = rm._window_sums(px, py, sd[g0:g1], c)
                groups.append(int(np.asarray(f)))
                gx.append(x), gy.append(y), gz.append(z), gi.append(inf)
            gx, gy, gz = (jnp.concatenate(v, axis=1) for v in (gx, gy, gz))
            gi = jnp.concatenate(gi, axis=0)
            acc, f = rm._horner_full(gx, gy, gz, gi, c)
            aff = group.to_affine_ints(group_t.to_g1(rm.to_g1t(acc)))[0]
            out["msm"].append({
                "windows": {"x": words(gx), "y": words(gy), "z": words(gz),
                            "inf": [bool(v) for v in np.asarray(gi)]},
                "group_flags": groups,
                "result": {**lanes_of(acc), "flag": int(np.asarray(f)) | max(groups)},
                "affine": None if aff is None else [int(aff[0]), int(aff[1])],
            })
            progress(f"l13: msm13 {(n, c, lanes, wgroup)} recorded")
    k, tau = host["srs"]["k"], host["srs"]["tau"]
    params = ParamsKZG.unsafe_setup(k, tau=tau, windowed=False)
    eng = rm.Msm13(group_t.from_g1(params.g1_powers), c=4, lanes=4, wgroup=8)
    out["srs"] = {"ax13": words(eng.ax13), "ay13": words(eng.ay13)}
    progress("l13: Msm13 ax13 / ay13 recorded")
    return out


def record_l13() -> dict:
    """The lazy-13 vector: the reference's outputs, from a subprocess (slow:
    about an hour, its MSMs run eagerly)."""
    host = l13_inputs()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, __file__, "l13-reference"], input=json.dumps(host),
                          stdout=subprocess.PIPE, text=True, env=env, cwd=ROOT, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"the lazy-13 recording failed (rc {proc.returncode})")
    outputs = {f"{key}_out": v for key, v in json.loads(proc.stdout.strip().splitlines()[-1]).items()}
    return {**host, "inputs_digest": sha256_json(host), **outputs, "outputs_digest": sha256_json(outputs)}


def quotient_circuit(name: str, package: str):
    """The ConstraintSystem of a quotient case, built with the classes of
    ``package`` ("jax", the reference, or "torch", the port)."""
    sys.path.insert(0, str(ROOT))
    from zkevm_tpu_torch.circuits import mpt_small as ms, toy

    if package == "jax":
        from zkevm_tpu.circuits import keccak_table as kt, mpt_circuit as mpt, poseidon_table as pt
        from zkevm_tpu.circuits.tables import Challenges
        from zkevm_tpu.plonk import ConstraintSystem
    else:
        from zkevm_tpu_torch.circuits import keccak_table as kt, mpt_circuit as mpt, poseidon_table as pt
        from zkevm_tpu_torch.circuits.tables import Challenges
        from zkevm_tpu_torch.plonk import ConstraintSystem
    if name == "toy":
        return toy.build_toy(ConstraintSystem)[0]
    if name == "two_phase":
        return toy.build_two_phase(ConstraintSystem)[0]
    if name == "mpt":
        return ms.build(ConstraintSystem, pt, mpt)[0]
    cs = ConstraintSystem()
    kt.configure(cs, Challenges.configure(cs))
    return cs


def column_key(col) -> list:
    return [col.kind, str(col.index), col.phase]


def quotient_columns(constraints) -> list:
    """Every column the constraint trees (of either package) query, in a
    fixed order: by ``column_key``."""
    cols, seen = {}, set()
    stack = [e for e, _ in constraints]
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        kind = type(e).__name__
        if kind == "Query":
            cols[tuple(column_key(e.column))] = e.column
        elif kind == "GroupQuery":
            cols.update({tuple(column_key(c)): c for c in e.group.columns})
        elif kind == "Neg":
            stack.append(e.inner)
        elif kind in ("Sum", "Prod"):
            stack += [e.a, e.b]
    return [cols[key] for key in sorted(cols)]


def quotient_inputs(name: str, cs) -> dict:
    """The fixed inputs of a quotient case over ``cs``: the protocol's
    challenges theta, beta, gamma, the circuit's challenges, y and the
    column order; the values come from ``quotient_values``."""
    from zkevm_tpu_torch.ff.goldens import FR_MOD
    from zkevm_tpu_torch.plonk.protocol import build_protocol

    seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "little")
    rng = np.random.default_rng(seed)

    def elem():
        return int.from_bytes(rng.bytes(32), "little") % FR_MOD

    inp = {"k": QUOTIENT_K, "seed": seed, "theta": elem(), "beta": elem(), "gamma": elem(),
           "y": elem(), "challenges": [elem() for _ in cs.challenges]}
    prot = build_protocol(cs, 1 << QUOTIENT_K, inp["theta"], inp["beta"], inp["gamma"])
    inp["columns"] = [column_key(c) for c in quotient_columns(prot.constraints)]
    return inp


def quotient_values(inp: dict) -> tuple[list, list]:
    """(values per column, domain_x) as field elements from the case's
    seed: random, with 0, 1 and r - 1 at rows 0 and n - 1 in turn."""
    from zkevm_tpu_torch.ff.goldens import FR_MOD

    n = 1 << inp["k"]
    rng = np.random.default_rng([inp["seed"], 1])
    edges = (0, 1, FR_MOD - 1)

    def column(j):
        v = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(n)]
        v[0], v[n - 1] = edges[j % 3], edges[(j + 1) % 3]
        return v

    return [column(j) for j in range(len(inp["columns"]))], column(len(inp["columns"]))


def reference_quotient(cs, inp: dict) -> list[int]:
    """The reference's quotient part over the case's inputs, as field
    elements: its ``build_protocol``, ``EvalContext`` and ``Expr.evaluate``,
    folded as its ``_h_part`` folds (``zkevm_tpu/plonk/prover.py:443-475``,
    copied: the fold is local to ``create_proof``). ``cs`` is the
    reference's ConstraintSystem."""
    import jax.numpy as jnp

    from zkevm_tpu.ff import FR
    from zkevm_tpu.ff import limbs as ff
    from zkevm_tpu.ff.goldens import FR_MOD
    from zkevm_tpu.plonk.expr import EvalContext
    from zkevm_tpu.plonk.protocol import build_protocol

    n = 1 << inp["k"]
    y = inp["y"]
    prot = build_protocol(cs, n, inp["theta"], inp["beta"], inp["gamma"])
    cols = quotient_columns(prot.constraints)
    if [column_key(c) for c in cols] != inp["columns"]:
        raise RuntimeError("the reference's circuit queries other columns than the case's")
    values, domain_x = quotient_values(inp)

    def enc(xs):
        return jnp.asarray(np.stack([FR.encode(v) for v in xs]))

    ctx = EvalContext({c: enc(v) for c, v in zip(cols, values)},
                      [jnp.asarray(FR.encode(v)) for v in inp["challenges"]], rot_scale=1, n=n)
    ctx.set_domain_x(enc(domain_x))
    y_m = jnp.asarray(FR.encode(y))
    hj = jnp.zeros((n, ff.L), jnp.uint32)
    for con, width in prot.constraints:
        v = con.evaluate(ctx)
        if width:
            ypows = np.stack([FR.encode(pow(y, width - 1 - z, FR_MOD)) for z in range(width)])
            fold = ff.mont_mul(FR, v, jnp.asarray(ypows)[None])
            m = 1
            while m < width:
                m *= 2
            if m != width:
                pad = jnp.zeros((fold.shape[0], m - width, ff.L), jnp.uint32)
                fold = jnp.concatenate([fold, pad], axis=1)
            while m > 1:
                m //= 2
                fold = ff.add(FR, fold[:, :m], fold[:, m:])
            yw = jnp.asarray(FR.encode(pow(y, width, FR_MOD)))
            hj = ff.add(FR, ff.mont_mul(FR, hj, yw), fold[:, 0])
        else:
            v = jnp.broadcast_to(v, (n, ff.L))
            hj = ff.add(FR, ff.mont_mul(FR, hj, y_m), v)
    return [FR.decode(row) for row in np.asarray(hj)]


def quotient_host() -> dict:
    """The inputs of the recorded quotient cases (cheap: port classes)."""
    return {name: quotient_inputs(name, quotient_circuit(name, "torch")) for name in QUOTIENT_RECORDED}


def record_quotient() -> dict:
    """The quotient vector: per case, the inputs and the reference's folded
    part (a few minutes: the reference's field ops compile per shape)."""
    host = quotient_host()
    outputs = {}
    for name, inp in host.items():
        outputs[f"{name}_fold"] = reference_quotient(quotient_circuit(name, "jax"), inp)
        progress(f"quotient: {name} recorded")
    return {**host, "inputs_digest": sha256_json(host), **outputs, "outputs_digest": sha256_json(outputs)}


def main(argv=None) -> int:
    which = (argv if argv is not None else sys.argv[1:]) or ["toy", "mpt", "kzg", "mesh", "l13", "quotient"]
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    if which == ["mesh-forced-host"]:  # the subprocess of record_mesh
        print(json.dumps(_mesh_forced_host(json.loads(sys.stdin.read()))))
        return 0
    if which == ["l13-reference"]:  # the subprocess of record_l13
        print(json.dumps(_l13_reference(json.loads(sys.stdin.read()))))
        return 0
    if "toy" in which:
        OUT.write_text(json.dumps(record(), indent=1) + "\n")
        print(f"wrote {OUT}")
    if "mpt" in which:
        MPT_OUT.write_text(json.dumps(record_mpt(), indent=1) + "\n")
        print(f"wrote {MPT_OUT}")
    if "kzg" in which:
        KZG_OUT.write_text(json.dumps(record_kzg(), indent=1) + "\n")
        print(f"wrote {KZG_OUT}")
    if "mesh" in which:
        MESH_OUT.write_text(json.dumps(record_mesh(), indent=1) + "\n")
        print(f"wrote {MESH_OUT}")
    if "l13" in which:
        L13_OUT.write_text(json.dumps(record_l13(), indent=1) + "\n")
        print(f"wrote {L13_OUT}")
    if "quotient" in which:
        QUOTIENT_OUT.write_text(json.dumps(record_quotient(), indent=1) + "\n")
        print(f"wrote {QUOTIENT_OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
