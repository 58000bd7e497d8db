#!/usr/bin/env python3
"""Where kernel M's time goes, and how fast one Fr product runs, on one GPU.

    python3 scripts/probe_quotient.py [--seed N] [--steps S] [--alt] [--against NAME=DIR ...]

Prints, on the card (it fails without one):

1. the sustained rate of the BN254 Fr Montgomery product, in products per
   second, in three forms (``scripts/probe_quotient.cu``: the 64-bit CIOS
   product field.cuh held before, field.cuh's PTX carry chains inlined, and
   the same as a called function), each over long chains in registers on a
   grid far larger than the card keeps resident, with each form's
   registers, stack and spills from ``ptxas -v``; the three must give the
   same words;
2. kernel M (``csrc/quotient.cu``) on one quotient part of the KeccakTable
   circuit and of the state-trie (MPT, depth 248) circuit at k = 20: the
   part's program compiled from the circuit's constraints, as
   ``create_proof`` compiles it, over random columns of the part's shape
   (M does the same work whatever the values; held to its plain version
   on 128 rows), in three variants of the same program fed to the same
   kernel:
     ``as_is``   the program;
     ``adds``    every product replaced by an addition of the same operands
                 (a fold becomes an addition whose result no one reads):
                 dispatch, register file and loads;
     ``loads``   only the loads, the lane loops around them and one fold:
                 the loads alone;
   and the split of ``as_is`` into products (as_is - adds), dispatch and
   register file (adds - loads) and loads;
3. with ``--alt``, M on both parts and kernel B at k = 20 (one column and
   16 columns) built once more with the other form of the product (each
   ``fe_mul<FR>`` of their sources made a call of ``fe_mul_call<FR>``, and
   each call inlined) beside the kernels as they are, in turns;
4. with ``--against NAME=DIR`` (repeatable), another kernel M on both
   parts in turns with this tree's: DIR holds a ``quotient.py`` (the
   program compiler and wrapper, as in ``zkevm_tpu_torch/plonk``) and its
   ``quotient.cu``, which is built against this tree's headers (so an older
   M runs with this tree's product). Each compiles the part's constraints
   its own way; the results must be the same words.

Run it on the card from the repository root (~2 minutes, the kernels'
build included). It writes its JSON to ``build/probe_quotient.json`` as
well.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402  (the smoke's timing, bound and ptxas helpers)
from zkevm_tpu_torch import kernels  # noqa: E402

PROBE_CU = ROOT / "scripts" / "probe_quotient.cu"
PROBE_BUILD = ROOT / "build" / "probe"
FORMS = ("cios", "ptx_inline", "ptx_call")


def log(msg: str) -> None:
    print(msg, flush=True)


def build(src: Path, name: str, defines: tuple = ()) -> tuple[ctypes.CDLL, str]:
    """Compile ``src`` with the kernels' nvcc flags (and ``defines``) into
    build/probe; returns the loaded library and nvcc's output."""
    flags = [*kernels.NVCC_FLAGS, f"-I{kernels.CSRC}", *(f"-D{d}" for d in defines)]
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    for cuh in sorted(kernels.CSRC.glob("*.cuh")):
        h.update(cuh.read_bytes())
    PROBE_BUILD.mkdir(parents=True, exist_ok=True)
    out = PROBE_BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"
    proc = subprocess.run([kernels.nvcc_path(), *flags, "-o", str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out)), proc.stdout + proc.stderr


@contextmanager
def library(name: str, lib: ctypes.CDLL):
    """Route the port's launches of library ``name`` to ``lib`` for a while."""
    saved = kernels._libs.get(name)
    kernels._libs[name] = lib
    stale = [key for key in kernels._fns if key[0] == name]
    for key in stale:
        del kernels._fns[key]
    try:
        yield
    finally:
        for key in [key for key in kernels._fns if key[0] == name]:
            del kernels._fns[key]
        if saved is None:
            del kernels._libs[name]
        else:
            kernels._libs[name] = saved


def other_form(name: str, sources: tuple) -> ctypes.CDLL:
    """csrc/``sources[0]`` built once more with the other form of field.cuh's
    product: in it and in the rest of ``sources`` (headers it includes),
    every inlined ``fe_mul<FR>`` becomes a call of ``fe_mul_call<FR>`` and
    every call an inlined product."""
    folder = PROBE_BUILD / f"other_form_{name}"
    folder.mkdir(parents=True, exist_ok=True)
    for src in sources:
        text = (kernels.CSRC / src).read_text().replace("fe_mul<FR>(", "\0")
        text = text.replace("fe_mul_call<FR>(", "fe_mul<FR>(").replace("\0", "fe_mul_call<FR>(")
        (folder / src).write_text(text)
    return build(folder / sources[0], f"{name}_other_form")[0]


def random_fr(torch, shape, gen) -> "torch.Tensor":
    """Canonical Fr words of ``shape`` (..., 8) made on the card."""
    from zkevm_tpu_torch.ff.field import FR

    w = torch.randint(-(1 << 31), 1 << 31, shape, generator=gen, dtype=torch.int32, device="cuda")
    top = (FR.modulus >> 224) & 0xFFFFFFFF
    w[..., 7] = (w[..., 7].to(torch.int64) & 0xFFFFFFFF).remainder(top).to(torch.int32)
    return w


def ptxas_by_symbol(nvcc_log: str) -> dict:
    """{mangled symbol: registers, stack, spill bytes} from ``ptxas -v``."""
    out, name = {}, None
    for line in nvcc_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


# ---------------------------------------------------------------------------
# 1. product rates
# ---------------------------------------------------------------------------

def product_rates(torch, gen, steps: int) -> dict:
    lib, nvcc_log = build(PROBE_CU, "probe_quotient")
    fn = lib.zk_probe_chain
    fn.argtypes = [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    threads = 132 * 2048 * 4
    inp = random_fr(torch, (threads, 3, 8), gen)
    outs = {}
    result = {"threads": threads, "steps": steps, "products": 2 * threads * steps}
    ptxas = ptxas_by_symbol(nvcc_log)
    for form, name in enumerate(FORMS):
        out = torch.empty(threads, 2, 8, dtype=torch.int32, device="cuda")

        def run(out=out, form=form):
            err = fn(out.data_ptr(), inp.data_ptr(), threads, steps, form,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"zk_probe_chain form {form}: CUDA error {err}")

        ms = smoke.cuda_ms(torch, run, reps=3)
        outs[name] = out
        kernel = next((v for k, v in ptxas.items() if "chain_kernel" in k and f"ILi{form}E" in k), None)
        result[name] = {"ms": ms, "products_per_s": 2 * threads * steps / (ms / 1e3), "ptxas": kernel}
        log(f"  {name:10s} {ms:9.3f} ms  {result[name]['products_per_s']:.4e} products/s  ptxas {kernel}")
    for name in FORMS[1:]:
        if not torch.equal(outs[name], outs[FORMS[0]]):
            raise AssertionError(f"product form {name} gives other words than {FORMS[0]}")
    result["ptxas_all"] = ptxas
    bound = smoke.INT32_OPS_PER_S / smoke.MUL_INT_OPS
    result["bound_products_per_s"] = bound
    log(f"  the three forms give the same words; bound {bound:.4e} products/s "
        f"({smoke.MUL_INT_OPS} multiply instructions at {smoke.INT32_OPS_PER_S:.4e}/s)")
    return result


# ---------------------------------------------------------------------------
# 2. kernel M's split
# ---------------------------------------------------------------------------

def circuit(name: str):
    """The constraint system of a main path's circuit at k = 20."""
    from zkevm_tpu_torch.plonk import ConstraintSystem

    if name == "keccak_table":
        from zkevm_tpu_torch.circuits import keccak_table as kt
        from zkevm_tpu_torch.circuits.tables import Challenges

        cs = ConstraintSystem()
        kt.configure(cs, Challenges.configure(cs))
        return cs
    from zkevm_tpu_torch.circuits import mpt_circuit as mpt, mpt_small as ms, poseidon_table as pt

    return ms.build(ConstraintSystem, pt, mpt, depth=smoke.MPT_DEPTH)[0]


def _loads():
    from zkevm_tpu_torch.plonk import quotient as q

    return (q.OP_COL, q.OP_GROUP, q.OP_CONST, q.OP_X)


def variant_program(constraints, cols, n: int, variant: str):
    """compile_constraints with the SSA instructions rewritten before
    register allocation: ``as_is``, ``adds`` or ``loads`` (module doc)."""
    from zkevm_tpu_torch.plonk import quotient as q

    b = q._Builder(cols, n)
    seen: set = set()
    for e, _ in constraints:
        b.count_parents(e, seen)
    for e, width in constraints:
        b.constraint(e, width)
    if variant == "adds":
        ins = []
        for op, dst, srcs, a, bb in b.ins:
            if op == q.OP_MUL:
                op = q.OP_ADD
            elif op == q.OP_FOLD:
                op, dst, srcs = q.OP_ADD, b.n_values, (srcs[0], srcs[0])
                b.n_values += 1
            ins.append((op, dst, srcs, a, bb))
        b.ins = ins
    elif variant == "loads":
        keep = _loads() + (q.OP_LANES, q.OP_END_LANES)
        ins = [i for i in b.ins if i[0] in keep]
        first = next(i[1] for i in ins if i[0] in _loads() and i[0] != q.OP_GROUP)
        b.ins = ins + [(q.OP_FOLD, None, (first,), 0, 0)]
    elif variant != "as_is":
        raise ValueError(variant)
    return b.finish(n)


def m_split(torch, gen, rng, k: int = 20, alt=None) -> dict:
    from zkevm_tpu_torch.ff.field import FR
    from zkevm_tpu_torch.plonk import quotient as q
    from zkevm_tpu_torch.plonk.protocol import build_protocol

    n = 1 << k
    out = {}
    for name in ("keccak_table", "mpt"):
        cs = circuit(name)
        ints = [int.from_bytes(rng.bytes(32), "little") % FR.modulus for _ in range(4 + len(cs.challenges))]
        prot = build_protocol(cs, n, *ints[:3])
        cols = q.queried_columns(prot.constraints)
        part_vals = random_fr(torch, (len(cols), n, 8), gen)
        domain_x = random_fr(torch, (n, 8), gen)
        ch = [FR.const(v, "cuda") for v in ints[4:]]
        row = {"columns": len(cols)}
        for variant in ("as_is", "adds", "loads"):
            prog = variant_program(prot.constraints, cols, n, variant)
            consts = q.constants_table(prog, ints[3], ch, "cuda")
            ms = smoke.cuda_ms(torch, lambda: q.evaluate(prog, part_vals, domain_x, consts), reps=3)
            row[variant] = {"ms": ms, "instructions": len(prog.code), "registers": prog.n_regs,
                            "products": prog.muls, "additions": prog.adds}
            if variant == "as_is":
                rows = np.concatenate([np.arange(32), np.arange(n - 32, n), rng.choice(n, 64, replace=False)])
                got = q.evaluate(prog, part_vals, domain_x, consts)[torch.from_numpy(rows).cuda()]
                if not torch.equal(got, q.plain_evaluate(prog, part_vals, domain_x, consts, rows=rows)):
                    raise AssertionError(f"kernel M differs from its plain version on the {name} part")
                b, by = smoke.bound(4 * (part_vals.numel() + domain_x.numel()) + 32 * n, prog.int_ops())
                row["bound_ms"], row["bound_by"] = b, by
                row["program"] = prog.describe()
                if alt is not None:
                    with library("quotient", alt):
                        alt_ms = smoke.cuda_ms(torch, lambda: q.evaluate(prog, part_vals, domain_x, consts),
                                               reps=3)
                    again = smoke.cuda_ms(torch, lambda: q.evaluate(prog, part_vals, domain_x, consts), reps=3)
                    row["as_is"]["ms_turns"] = [ms, again]
                    row["as_is_other_form_ms"] = alt_ms
                    log(f"  {name:12s} as_is, the other form of the product: {alt_ms:.3f} ms "
                        f"(as it is, again {again:.3f} ms)")
            log(f"  {name:12s} {variant:6s} {ms:9.3f} ms  {prog.describe()}")
        t, a, ld = row["as_is"]["ms"], row["adds"]["ms"], row["loads"]["ms"]
        row["split_ms"] = {"products": t - a, "dispatch_and_register_file": a - ld, "loads": ld}
        row["split_share"] = {key: v / t for key, v in row["split_ms"].items()}
        log(f"  {name:12s} split of {t:.3f} ms (bound {row['bound_ms']:.3f} ms, {row['bound_by']}): "
            + json.dumps({key: round(v, 3) for key, v in row["split_ms"].items()}))
        out[name] = row
        del part_vals
        torch.cuda.empty_cache()
    return out


def load_other(name: str, folder: Path):
    """(module, library) of another kernel M: DIR/quotient.py imported as a
    module of the port's package, DIR/quotient.cu built against this tree's
    headers."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"zkevm_tpu_torch.plonk._probe_{name}", folder / "quotient.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    lib, nvcc_log = build(folder / "quotient.cu", f"quotient_{name}")
    return mod, lib, ptxas_by_symbol(nvcc_log)


def m_against(torch, gen, rng, others: dict, k: int = 20, turns: int = 2) -> dict:
    """This tree's M and each of ``others`` ({name: (module, library)}) on
    the KeccakTable and MPT parts, in turns: this, the others, the others
    backwards, this, ``turns`` times."""
    from zkevm_tpu_torch.ff.field import FR
    from zkevm_tpu_torch.plonk import quotient as q
    from zkevm_tpu_torch.plonk.protocol import build_protocol

    n = 1 << k
    mods = {"this": (q, None), **others}
    out = {}
    for name in ("keccak_table", "mpt"):
        cs = circuit(name)
        ints = [int.from_bytes(rng.bytes(32), "little") % FR.modulus for _ in range(4 + len(cs.challenges))]
        prot = build_protocol(cs, n, *ints[:3])
        cols = q.queried_columns(prot.constraints)
        part_vals = random_fr(torch, (len(cols), n, 8), gen)
        domain_x = random_fr(torch, (n, 8), gen)
        runs = {}
        for label, (mod, lib) in mods.items():
            prog = mod.compile_constraints(prot.constraints, cols, n)
            consts = mod.constants_table(prog, ints[3], [FR.const(v, "cuda") for v in ints[4:]], "cuda")
            runs[label] = (mod, lib, prog, consts)
        want = None
        times: dict = {label: [] for label in runs}
        order = list(runs)[1:]
        for _ in range(turns):
            for label in ["this", *order, *order[::-1], "this"]:
                mod, lib, prog, consts = runs[label]

                def run(mod=mod, prog=prog, consts=consts):
                    return mod.evaluate(prog, part_vals, domain_x, consts)

                if lib is None:
                    got, ms = run(), smoke.cuda_ms(torch, run, reps=3)
                else:
                    with library("quotient", lib):
                        got, ms = run(), smoke.cuda_ms(torch, run, reps=3)
                if want is None:
                    want = got
                elif not torch.equal(got, want):
                    raise AssertionError(f"kernel M of {label!r} gives other words on the {name} part")
                times[label].append(ms)
        out[name] = {label: {"ms_turns": t, "program": runs[label][2].describe()} for label, t in times.items()}
        log(f"  {name:12s} in turns: " + json.dumps({label: [round(v, 3) for v in t] for label, t in times.items()}))
        del part_vals, want
        torch.cuda.empty_cache()
    return out


def b_turns(torch, gen, alt) -> dict:
    """Kernel B at k = 20 on one and 16 columns, as it is against ``alt``,
    built with the other form of the product, in turns."""
    from zkevm_tpu_torch.poly import ntt as nt

    out = {}
    for batch in (1, 16):
        x = random_fr(torch, (batch, 1 << 20, 8), gen)
        want = nt.ntt(x)
        times = {"as_is": [], "other_form": []}
        for which in ("as_is", "other_form", "other_form", "as_is"):
            if which == "as_is":
                times[which].append(smoke.cuda_ms(torch, lambda: nt.ntt(x), reps=5))
            else:
                with library("ntt", alt):
                    if not torch.equal(nt.ntt(x), want):
                        raise AssertionError("ntt built with the other form of the product gives other words")
                    times[which].append(smoke.cuda_ms(torch, lambda: nt.ntt(x), reps=5))
        out[f"{batch} columns"] = times
        log(f"  ntt k=20 x {batch}: " + json.dumps({k: [round(v, 4) for v in t] for k, t in times.items()}))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--steps", type=int, default=256)
    ap.add_argument("--alt", action="store_true", help="also time M and B with the other form of the product")
    ap.add_argument("--against", action="append", default=[], metavar="NAME=DIR",
                    help="also time the kernel M of DIR (quotient.py, quotient.cu) in turns with this tree's")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_quotient: no CUDA device", file=sys.stderr)
        return 1
    card = smoke.card_line()
    log(card)
    t = time.perf_counter()
    kernels.build_all()
    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "ptxas": {lib: ptxas_by_symbol(kernels.BUILD_LOGS.get(lib, "")) for lib in ("quotient", "ntt")}}
    log("ptxas -v of M and B: " + json.dumps(result["ptxas"]))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    log("product rates (Fr, chains in registers):")
    result["rates"] = product_rates(torch, gen, args.steps)
    alt = {}
    if args.alt:
        alt["quotient"] = other_form("quotient", ("quotient.cu",))
        alt["ntt"] = other_form("ntt", ("ntt.cu", "ntt_common.cuh"))
    log("kernel M on one part at k = 20, three variants of the program:")
    result["m"] = m_split(torch, gen, np.random.default_rng(args.seed), alt=alt.get("quotient"))
    if args.against:
        others, result["against_ptxas"] = {}, {}
        for spec in args.against:
            name, folder = spec.split("=", 1)
            mod, lib, ptxas = load_other(name, Path(folder).resolve())
            others[name] = (mod, lib)
            result["against_ptxas"][name] = ptxas
            log(f"  {name}: ptxas {json.dumps(ptxas)}")
        log("kernel M of this tree and of " + ", ".join(others) + " in turns:")
        result["against"] = m_against(torch, gen, np.random.default_rng(args.seed + 1), others)
    if args.alt:
        log("kernel B at k = 20, as it is and with the other form of the product, in turns:")
        result["b"] = b_turns(torch, gen, alt["ntt"])
    result["seconds"] = time.perf_counter() - t
    out = ROOT / "build" / "probe_quotient.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    log(json.dumps({key: result[key] for key in ("card", "device", "seconds")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
