#!/usr/bin/env python3
"""Where kernel L's time goes, stage by stage, on one GPU.

    python3 scripts/probe_msm13.py [--seed N] [--reps R] [--against NAME=DIR ...]

Prints, on the card (it fails without one):

1. the registers, stack frame and spills of every kernel of L
   (``csrc/msm13.cu``), from ``ptxas -v`` of the build, and the instruction
   mix of each of its functions (``cuobjdump -sass``: the count of each
   opcode class, the ten largest);
2. kernel L's MSM (``ec/msm13.py`` ``msm13``: c = 16, lanes 4096, window
   groups of 8, as the l13 engine runs it) at n = 2^20 and 2^14 over the
   affine lazy-13 bases of an ``unsafe_setup`` SRS and random 253-bit
   scalars, timed by stage with CUDA events (each stage's mean device
   milliseconds over R runs after a warm-up; a stage that runs once per
   window group sums its groups; ``tree_top`` is the boundary tree's largest
   level, ``tree_rest`` the other levels), with its launches per MSM, its
   doubling flag and its bound (``chip_smoke.msm13_work``); the result is
   held to C's MSM by affine point;
3. with ``--against NAME=DIR`` (repeatable), the kernel L of another
   checkout DIR (its ``zkevm_tpu_torch/ec/msm13.py``, imported as a module
   of this tree's package, and its ``zkevm_tpu_torch/csrc/msm13.cu``, built
   with its own headers) at both sizes in turns with this tree's: this, the
   others, the others backwards, this, twice; each timing is the mean of R
   calls; the results must be the same affine points.

Run it on the card from the repository root (a few minutes, the kernels'
build included). It writes its JSON to ``build/probe_msm13.json`` as
well.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (the smoke's timing, bound and ptxas helpers)
from zkevm_tpu_torch import kernels  # noqa: E402

PROBE_BUILD = ROOT / "build" / "probe"
SIZES = (1 << 20, 1 << 14)


def log(msg: str) -> None:
    print(msg, flush=True)


def build_others(specs: list) -> dict:
    """{name: (module, library, ptxas)} of the kernel L of each other
    checkout (NAME=DIR), their nvcc processes run in parallel."""
    import ctypes

    PROBE_BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for spec in specs:
        name, folder = spec.split("=", 1)
        checkout = Path(folder).resolve()
        src = checkout / "zkevm_tpu_torch" / "csrc" / "msm13.cu"
        h = hashlib.sha256(src.read_bytes() + " ".join(kernels.NVCC_FLAGS).encode())
        for cuh in sorted(src.parent.glob("*.cuh")):
            h.update(cuh.read_bytes())
        out = PROBE_BUILD / f"libmsm13_{name}-{h.hexdigest()[:16]}.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", str(out), str(src)]
        procs[name] = (checkout, out, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                       text=True))
    others = {}
    for name, (checkout, out, proc) in procs.items():
        nvcc_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{nvcc_log}")
        spec = importlib.util.spec_from_file_location(f"zkevm_tpu_torch.ec._probe_{name}",
                                                      checkout / "zkevm_tpu_torch" / "ec" / "msm13.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        others[name] = (mod, ctypes.CDLL(str(out)), smoke.ptxas_summary(nvcc_log))
    return others


def sass_mix(lib: Path) -> dict:
    """{function: {"total": n, opcode: count, ...}} of a built library
    (``cuobjdump -sass``), each function's ten most frequent opcodes."""
    import re
    from collections import Counter

    tool = Path(kernels.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    out, name, counts = {}, None, Counter()
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name:
                out[name] = {"total": sum(counts.values()), **dict(counts.most_common(10))}
            name, counts = m.group(1), Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if m and name:
            counts[m.group(1).split(".")[0]] += 1
    if name:
        out[name] = {"total": sum(counts.values()), **dict(counts.most_common(10))}
    return out


def random_scalars(torch, n: int, gen):
    """(n, 8) standard-form words of random 253-bit scalars (below r)."""
    words = torch.randint(-(1 << 31), 1 << 31, (n, 8), generator=gen, dtype=torch.int64, device="cuda")
    words[:, 7] &= (1 << 29) - 1
    return words.to(torch.int32).contiguous()


def affine(torch, m13, got) -> list:
    from zkevm_tpu_torch.ec import group

    return group.to_affine_ints(m13.to_point(got))


def split(torch, m13, engine, sc, reps: int) -> dict:
    """L's stages at this size, its launches, flag, bound and check."""
    from zkevm_tpu_torch.ec import group, msm as msmmod

    n = sc.shape[0]

    def run(marks):
        return engine.raw(sc, marks=marks)

    stages = smoke.stage_ms(torch, run, reps=reps)
    kernels.reset_launches()
    got, flag = run(None)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["msm13"]
    want = msmmod.MSM(engine.points)(sc)
    if flag or affine(torch, m13, got) != group.to_affine_ints(want[None]):
        raise AssertionError(f"msm13 n={n}: flag {flag}, or its result differs from C's msm")
    ms = smoke.cuda_ms(torch, lambda: run(None), reps=reps)
    b, by = smoke.bound(*smoke.msm13_work(torch, sc, engine.c, engine.lanes, engine.wgroup))
    total = sum(stages.values())
    log(f"  n={n}: {ms:.3f} ms (stages sum {total:.3f}), {launches} launches, flag {flag}, bound {b:.3f} ms "
        f"({by}); held to C's msm")
    for name, v in stages.items():
        log(f"    {name:14s} {v:9.3f} ms  {100 * v / total:5.1f}%")
    return {"ms": ms, "stages": stages, "launches": launches, "flag": flag, "bound_ms": b, "bound_by": by}


def turns(torch, m13, engine, others: dict, sc, reps: int, rounds: int = 2) -> dict:
    """This tree's L and each other L ({name: (module, library)}) in turns
    on the same inputs; every result the same affine point."""
    from probe_quotient import library  # the launch router of the quotient probe

    ref = None
    times = {name: [] for name in ("this", *others)}

    def timed(name):
        nonlocal ref
        if name == "this":
            fn = lambda: engine.raw(sc)  # noqa: E731
            got = fn()[0]
            times[name].append(smoke.cuda_ms(torch, fn, reps=reps))
        else:
            mod, lib = others[name]
            kw = {"bases": engine.bases13} if "bases" in inspect.signature(mod.msm13).parameters else {}
            with library("msm13", lib):
                fn = lambda: mod.msm13(engine.ax13, engine.ay13, sc, c=engine.c, lanes=engine.lanes,  # noqa: E731
                                       wgroup=engine.wgroup, **kw)
                got = fn()[0]
                times[name].append(smoke.cuda_ms(torch, fn, reps=reps))
        pt = affine(torch, m13, got)
        if ref is None:
            ref = pt
        elif pt != ref:
            raise AssertionError(f"msm13 of {name} differs from this tree's by affine point")

    order = ["this", *others, *reversed(list(others)), "this"]
    for _ in range(rounds):
        for name in order:
            timed(name)
    return times


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--against", action="append", default=[], metavar="NAME=DIR",
                    help="also time the kernel L of checkout DIR in turns with this tree's")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_msm13: no CUDA device", file=sys.stderr)
        return 1
    from zkevm_tpu_torch.ec import msm13 as m13
    from zkevm_tpu_torch.kzg import ParamsKZG

    card = smoke.card_line()
    log(card)
    t = time.perf_counter()
    built = kernels.build_all()
    result = {"card": card, "device": torch.cuda.get_device_name(0), "build_s": built.get("msm13"),
              "ptxas": smoke.ptxas_summary(kernels.BUILD_LOGS.get("msm13", ""))}
    log("ptxas -v of L: " + json.dumps(result["ptxas"]))
    result["sass"] = sass_mix(kernels._lib_path("msm13"))
    for fn, mix in result["sass"].items():
        log(f"  sass {fn}: {json.dumps(mix)}")
    others = {}
    for name, (mod, lib, ptxas) in build_others(args.against).items():
        others[name] = (mod, lib)
        result.setdefault("against_ptxas", {})[name] = ptxas
        log(f"ptxas -v of {name}'s L: {json.dumps(ptxas)}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    points = ParamsKZG.unsafe_setup(20, device="cuda").g1_powers
    sc_all = random_scalars(torch, SIZES[0], gen)
    result["sizes"] = {}
    for n in SIZES:
        engine = m13.Msm13(points[:n].contiguous())
        sc = sc_all[:n].contiguous()
        log(f"kernel L at n = {n} (c = 16, lanes 4096, wgroup 8):")
        entry = split(torch, m13, engine, sc, args.reps)
        if others:
            entry["turns"] = turns(torch, m13, engine, others, sc, args.reps)
            log("  in turns (ms): " + json.dumps(entry["turns"]))
        result["sizes"][str(n)] = entry
        del engine
        torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t
    out = ROOT / "build" / "probe_msm13.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    log(json.dumps({key: result[key] for key in ("card", "device", "seconds")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
