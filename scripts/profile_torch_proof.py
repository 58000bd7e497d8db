#!/usr/bin/env python3
"""Where the time of one KeccakTable proof goes on the GPU.

Usage: python3 scripts/profile_torch_proof.py [--seed 1]

Builds the port's kernels, sets up the SRS at k=20, assigns the KeccakTable
circuit with the same messages as ``chip_smoke.py`` and runs keygen (untimed),
then runs ``create_proof`` once under ``torch.profiler`` and prints:

- the proof's wall time (host clock around the call, synchronised);
- the device's busy time (union of all kernel intervals) and idle share;
- device time by kernel, largest first, with launch counts;
- the card's name and power limit.

The full table goes to ``build/profile_k20.json`` in the checkout.
Needs one GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from zkevm_tpu_torch import kernels
    from zkevm_tpu_torch.circuits import keccak_table as kt
    from zkevm_tpu_torch.circuits.tables import Challenges
    from zkevm_tpu_torch.kzg import ParamsKZG
    from zkevm_tpu_torch.plonk import ConstraintSystem, create_proof, keygen, verify_proof

    if not torch.cuda.is_available():
        print("profile_torch_proof: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    kernels.build_all()
    k = chip_smoke.MAIN_K
    n = 1 << k
    cs = ConstraintSystem()
    cfg = kt.configure(cs, Challenges.configure(cs))
    msgs = chip_smoke.keccak_messages(np.random.default_rng(args.seed), kt.num_perms(cs, n))
    params = ParamsKZG.unsafe_setup(k, device="cuda")
    wit = kt.assign(cs, cfg, n, msgs)
    pk = keygen(params, cs, wit.asg)
    torch.cuda.synchronize()

    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        proof = create_proof(params, pk, [], wit.witness_phases(), seed=args.seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = kernels.launch_counts()
    if not verify_proof(params, pk.vk, [], proof):
        raise AssertionError("the profiled proof does not verify")

    intervals = []
    by_name = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        intervals.append((start, end))
        by_name[ev.name][0] += (end - start) / 1e6
        by_name[ev.name][1] += 1
    intervals.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    busy /= 1e6
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    print(f"create_proof k={k}: wall {wall:.2f} s, device busy {busy:.2f} s, "
          f"idle share {1 - busy / wall:.3f}")
    print(f"launch counts: {json.dumps(launches)}")
    for name, (sec, count) in rows[:25]:
        print(f"  {sec:9.3f} s {count:8d}x  {name[:110]}")
    out = ROOT / "build" / f"profile_k{k}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "k": k, "wall_s": wall, "device_busy_s": busy, "launches": launches,
        "kernels": [{"name": k, "seconds": v[0], "count": v[1]} for k, v in rows],
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
