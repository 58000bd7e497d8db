"""Kernel L's plain path (``zkevm_tpu_torch/ec/msm13.py``) on the CPU: the
point formulas and ``msm13`` against the reference's outputs recorded in
``tests/vectors/torch_port_l13.json`` word for word, flags included (the
reference's c = 16 MSM compiles for minutes, so its outputs are recorded
once); ``Msm13`` against the golden model by affine point, its fallback to
the Pippenger MSM, a toy proof committed through it, and the engine choice of
``unsafe_setup``.

At c = 4 and c = 16 the reference's doubling flag fires on every MSM of
254-bit scalars: the top window's digits stop short of 2^c, so the boundary
tree adds equal prefix sums. The plain version with ``complete=False`` does
the same, word for word; kernel L's order (the default) doubles there, raises
no flag, and its own result is held to the golden model."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zkevm_tpu_torch import convert
from zkevm_tpu_torch.circuits import toy
from zkevm_tpu_torch.ec import goldens as g1g, group, msm as cmsm, msm13
from zkevm_tpu_torch.ff import field as ff
from zkevm_tpu_torch.ff.goldens import FR_MOD
from zkevm_tpu_torch.kzg import ParamsKZG
from zkevm_tpu_torch.plonk import Assignment, ConstraintSystem, create_proof, keygen
from zkevm_tpu_torch.plonk.prover import proof_to_json

VECTORS = Path(__file__).resolve().parent.parent / "vectors"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vec():
    return json.loads((VECTORS / "torch_port_l13.json").read_text())


def _coords(lanes, k):
    return torch.tensor(np.array([ln[k] for ln in lanes], dtype=np.int32).T.copy())


def _g1l(lanes) -> msm13.G1L:
    return msm13.G1L(*(_coords(lanes, k) for k in range(3)), torch.tensor([bool(ln[3]) for ln in lanes]))


def _words(lanes) -> np.ndarray:
    return np.array(lanes, dtype=np.int64).T  # (21, B)


def _same_lanes(p: msm13.G1L, rec: dict):
    for k in ("x", "y", "z"):
        np.testing.assert_array_equal(getattr(p, k).reshape(21, -1).numpy().astype(np.int64), _words(rec[k]), k)
    assert p.inf.reshape(-1).tolist() == rec["inf"]


def _scalars(vals):
    return ff.to_tensor(ff.words_from_ints(vals), "cpu")


def _golden(points, scalars):
    acc = None
    for pt, k in zip(points, scalars):
        acc = g1g.add(acc, g1g.scalar_mul(tuple(pt), k))
    return acc


@pytest.mark.parametrize("name", ["add", "add_dbl", "double", "madd", "madd_dbl"])
def test_point_ops_equal_recorded(vec, name):
    case, rec = vec["ops"][name], vec["ops_out"][name]
    p = _g1l(case["p"])
    if name.startswith("add"):
        out, flag = msm13.add_l(p, _g1l(case["q"]))
    elif name == "double":
        out, flag = msm13.double_l(p), None
    else:
        out, flag = msm13.madd_l(p, _coords(case["q"], 0), _coords(case["q"], 1))
    _same_lanes(out, rec)
    assert flag == rec["flag"]


@pytest.mark.parametrize("index", [0, 1, 2], ids=["16-c4", "64-c4", "16-c16"])
def test_msm13_equals_recorded(vec, index):
    case, rec = vec["msm"][index], vec["msm_out"][index]
    pts = group.from_affine_ints([tuple(p) for p in case["points"]], "cpu")
    engine = msm13.Msm13(pts, c=case["c"], lanes=case["lanes"], wgroup=case["wgroup"])
    sc = _scalars(case["scalars"])
    geo = (case["c"], 254, case["lanes"], case["wgroup"])
    out, flag, windows, group_flags = msm13.PLAIN["msm13"](engine.ax13, engine.ay13, sc, *geo, keep_windows=True,
                                                           complete=False)
    _same_lanes(windows, rec["windows"])
    assert group_flags == rec["group_flags"]
    _same_lanes(out, rec["result"])
    assert flag == rec["result"]["flag"] == 1  # the top window's repeated prefix sums
    want = _golden(case["points"], case["scalars"])
    assert group.to_affine_ints(engine(sc)[None]) == [want] and engine.fallbacks == 0  # L's own result


def test_srs_conversion_equals_recorded(vec):
    params = ParamsKZG.unsafe_setup(vec["srs"]["k"], tau=vec["srs"]["tau"], device="cpu")
    engine = msm13.Msm13(params.g1_powers, c=4, lanes=4, wgroup=8)
    ax = convert.l13_from_reference(_words(vec["srs_out"]["ax13"]).astype(np.uint32), "cpu")
    ay = convert.l13_from_reference(_words(vec["srs_out"]["ay13"]).astype(np.uint32), "cpu")
    assert torch.equal(engine.ax13, ax) and torch.equal(engine.ay13, ay)


def _random_bases(n, seed):
    rng = np.random.default_rng(seed)
    return [g1g.random_point(rng) for _ in range(n)], rng


def test_msm13_own_result_at_full_windows():
    """c = 2: 127 windows of two bits, no repeated prefix sums, no flag: the
    MSM's own result against the golden model (zero and r - 1 scalars among
    them)."""
    pts, rng = _random_bases(16, 21)
    vals = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(16)]
    vals[0], vals[1] = 0, FR_MOD - 1
    bases, sc = group.from_affine_ints(pts, "cpu"), _scalars(vals)
    engine = msm13.Msm13(bases, c=2, lanes=4, wgroup=64)
    out, flag = msm13.msm13(engine.ax13, engine.ay13, sc, c=2, lanes=4, wgroup=64)
    assert flag == 0
    got = group.to_affine_ints(msm13.to_point(out))
    assert got == [_golden(pts, vals)]
    assert engine.fallbacks == 0


@pytest.mark.parametrize("case", ["equal bases and scalars", "zero scalars", "0/1 scalars"])
def test_fallback_is_counted_and_right(case):
    """Equal bases with equal scalars make the scan add a point to itself:
    the flag, and a counted fallback. All-zero scalars (every boundary holds
    the window total) give the identity with no flag, and 0/1 scalars (every
    boundary past 1 holds it) their sum."""
    pts, rng = _random_bases(16, 22)
    if case == "equal bases and scalars":
        pts = [pts[0]] * 16
        vals = [int.from_bytes(rng.bytes(32), "little") % FR_MOD] * 16
    elif case == "zero scalars":
        vals = [0] * 16
    else:
        vals = [int(v) for v in rng.integers(0, 2, 16)]
    engine = msm13.Msm13(group.from_affine_ints(pts, "cpu"), c=4, lanes=4, wgroup=128)
    forced = case == "equal bases and scalars"
    got = engine(_scalars(vals))
    assert engine.fallbacks == forced
    assert group.to_affine_ints(got[None]) == [_golden(pts, vals)]
    if case == "zero scalars":
        assert bool(ff.is_zero(got[2]))


def test_toy_proof_through_msm13():
    """The K=5 toy proof with every commitment through Msm13 (c = 4) on a
    ParamsKZG built directly equals the reference's recorded proof, with
    no fallback."""
    ref = json.loads((VECTORS / "torch_port_toy_proof.json").read_text())
    base = ParamsKZG.unsafe_setup(ref["k"], tau=ref["tau"], device="cpu")
    engine = msm13.Msm13(base.g1_powers, c=4, lanes=4, wgroup=64)
    params = ParamsKZG(k=base.k, g1_powers=base.g1_powers, g2=base.g2, s_g2=base.s_g2, committer=engine)
    cs, cols = toy.build_toy(ConstraintSystem)
    asg = toy.assign_toy(cs, cols, Assignment)
    pk = keygen(params, cs, toy.fixed_only(cs, asg, Assignment))
    proof = proof_to_json(create_proof(params, pk, [], asg, seed=ref["toy"]["seed"]))
    assert [list(p) for p in pk.vk.fixed_commitments] == ref["toy"]["fixed_commitments"]
    assert all(proof[f] == ref["toy"]["proof"][f] for f in proof)
    assert engine.fallbacks == 0


@pytest.mark.parametrize("engine,cls", [(None, cmsm.MSM), ("l13", cmsm.MSM), ("ps", cmsm.MSM)])
def test_unsafe_setup_keeps_c_up_to_k10(engine, cls):
    """At k <= 10 the engine is C's MSM whatever is asked, as in the reference."""
    assert type(ParamsKZG.unsafe_setup(3, engine=engine, device="cpu").committer) is cls


def test_unsafe_setup_engine_names(monkeypatch):
    """Above k = 10: "l13" Msm13, "ps" C's MSM, "pippenger" G's Pippenger
    MSM, another name a ValueError; the keyword wins over ZKEVM_TPU_MSM,
    whose default is "ps"."""
    from zkevm_tpu_torch.ec.pippenger import PippengerMSM
    from zkevm_tpu_torch.kzg import params as pm

    made = {}
    monkeypatch.setattr(pm.msm13, "Msm13", lambda pts, **kw: made.setdefault("l13", kw) and "l13")
    pts = group.identity((1 << 11,), "cpu")
    monkeypatch.setattr(pm.group, "scalar_mul", lambda gen, sc: pts)
    monkeypatch.delenv("ZKEVM_TPU_MSM", raising=False)
    assert type(ParamsKZG.unsafe_setup(11, device="cpu").committer) is cmsm.MSM
    assert ParamsKZG.unsafe_setup(11, engine="l13", device="cpu").committer == "l13"
    assert made["l13"] == {"c": 16, "lanes": 4096, "wgroup": 8}
    monkeypatch.setenv("ZKEVM_TPU_MSM", "pippenger")
    assert type(ParamsKZG.unsafe_setup(11, device="cpu").committer) is PippengerMSM
    assert type(ParamsKZG.unsafe_setup(11, engine="ps", device="cpu").committer) is cmsm.MSM
    with pytest.raises(ValueError, match="engine"):
        ParamsKZG.unsafe_setup(11, engine="psmsm", device="cpu")


def test_group_constructors_default_to_the_card():
    """``group.identity`` and ``group.from_affine_ints`` resolve their device
    like every entry point: the card by default, raising without one."""
    if torch.cuda.is_available():
        assert group.identity((2,)).device.type == "cuda"
        assert group.from_affine_ints([g1g.G1_GEN]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            group.identity((2,))
        with pytest.raises(RuntimeError, match="CUDA"):
            group.from_affine_ints([g1g.G1_GEN])
    assert group.identity((2,), "cpu").device.type == "cpu"
