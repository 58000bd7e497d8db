#!/usr/bin/env python3
"""Kernel A (Fr product, addition, inversion), F and C's point addition at
``chip_smoke.py``'s shapes: this tree's build against another checkout's, in
turns, on one GPU.

    python3 scripts/turns_small_kernels.py DIR [--seed N] [--turns T] [--reps R]

DIR is the root of another checkout of this repository (for example the
parent commit unpacked with ``git archive`` into a directory under
``build/``). Its ``zkevm_tpu_torch/csrc/field.cu`` and ``curve.cu`` are
built with its own headers and called through this tree's wrappers, so
their C interfaces must be this tree's. The inputs are the smoke's: 2^20 Fr
elements (the product, the addition, the inversion), 2^20 words with zeros
(F), 4096 points (C's ``g1_add``). Each kernel runs this, other, other, this,
``T`` times, ``R`` calls a timing, and the other build's words must equal
this tree's. Prints the card and one JSON object {kernel: {"this": [ms],
"other": [ms]}}; it fails without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as smoke  # noqa: E402
import probe_quotient as probe  # noqa: E402  (build, library)
from zkevm_tpu_torch import kernels  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path, help="root of the other checkout")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("turns_small_kernels: no CUDA device", file=sys.stderr)
        return 1
    from zkevm_tpu_torch.ec import group
    from zkevm_tpu_torch.ff import field as ff

    print(smoke.card_line(), flush=True)
    kernels.build_all()
    csrc = args.other.resolve() / "zkevm_tpu_torch" / "csrc"
    other = {lib: probe.build(csrc / f"{lib}.cu", f"{lib}_other")[0] for lib in ("field", "curve")}
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(args.seed)
    n = 1 << 20
    a = smoke.random_field(torch, ff.FR, n, gen, dev)
    b = smoke.random_field(torch, ff.FR, n, gen, dev).flip(0).contiguous()
    words = smoke.random_words_with_zeros(torch, (n,), gen, dev)
    _, p = smoke._random_points(torch, 4096, np.random.default_rng(args.seed), dev)
    _, q = smoke._random_points(torch, 4096, np.random.default_rng(args.seed + 1), dev)
    cases = {
        "field_mul": ("field", lambda: ff.mont_mul(ff.FR, a, b)),
        "field_add_sub": ("field", lambda: ff.add(ff.FR, a, b)),
        "field_pow": ("field", lambda: ff.inv(ff.FR, a)),
        "field_nonzero": ("field", lambda: ff.nonzero(words)),
        "g1_add": ("curve", lambda: group.add(p, q)),
    }
    out = {}
    for name, (lib, fn) in cases.items():
        want = fn()
        times = {"this": [], "other": []}
        for _ in range(args.turns):
            for which in ("this", "other", "other", "this"):
                if which == "this":
                    times[which].append(smoke.cuda_ms(torch, fn, reps=args.reps))
                    continue
                with probe.library(lib, other[lib]):
                    if not torch.equal(fn(), want):
                        raise AssertionError(f"{name}: the other build gives other words")
                    times[which].append(smoke.cuda_ms(torch, fn, reps=args.reps))
        out[name] = times
        rounded = {k: [round(v, 4) for v in t] for k, t in times.items()}
        print(f"  {name:14s} " + json.dumps(rounded), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
