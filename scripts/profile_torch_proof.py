#!/usr/bin/env python3
"""Where the time of one k=20 proof goes on the GPU, for each main path.

Usage: python3 scripts/profile_torch_proof.py [--seed 1]

Builds the port's kernels and sets up the SRS at k=20. Then, for each of
the two main paths of ``chip_smoke.py``, with the same inputs (the
KeccakTable circuit under a Keccak transcript, then the MPT circuit over
the PoseidonTable at trie depth 248 with 32 chained updates under a
Poseidon transcript), it assigns the witness and runs keygen (untimed),
then runs ``create_proof`` once under ``torch.profiler`` and prints:

- the proof's wall time (host clock around the call, synchronised);
- the device's busy time (union of all kernel intervals) and idle share;
- device time by kernel, largest first, with launch counts;
- the card's name and power limit.

The full tables go to ``build/profile_k20.json`` (KeccakTable) and
``build/profile_mpt_k20.json`` in the checkout.
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


def witness_of(circuit: str, n: int, seed: int):
    """-> (cs, fixed assignment, witness, transcript class) of a main path."""
    import numpy as np

    import chip_smoke
    from zkevm_tpu_torch.circuits import keccak_table as kt
    from zkevm_tpu_torch.circuits import mpt_circuit as mpt, mpt_small as ms, poseidon_table as pt
    from zkevm_tpu_torch.circuits.tables import Challenges
    from zkevm_tpu_torch.plonk import Assignment, ConstraintSystem
    from zkevm_tpu_torch.state import ZkTrie
    from zkevm_tpu_torch.transcript import KeccakTranscript, PoseidonTranscript

    rng = np.random.default_rng(seed)
    if circuit == "keccak_table":
        cs = ConstraintSystem()
        cfg = kt.configure(cs, Challenges.configure(cs))
        wit = kt.assign(cs, cfg, n, chip_smoke.keccak_messages(rng, kt.num_perms(cs, n)))
        return cs, wit.asg, wit.witness_phases(), KeccakTranscript
    depth = chip_smoke.MPT_DEPTH
    cs, ptcfg, mcfg = ms.build(ConstraintSystem, pt, mpt, depth=depth)
    ups = chip_smoke.mpt_workload(rng, ZkTrie(depth=depth), mpt, chip_smoke.MPT_PREFILL,
                                  chip_smoke.MPT_UPDATES)
    asg = Assignment(cs, n)
    pt.assign(cs, ptcfg, n, mpt.poseidon_states(ups, depth), asg)
    mpt.assign(cs, mcfg, n, ups, asg)
    return cs, asg, asg, PoseidonTranscript


def profile_proof(circuit: str, params, seed: int) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from zkevm_tpu_torch import kernels
    from zkevm_tpu_torch.plonk import create_proof, keygen, verify_proof

    k = params.k
    cs, fixed, witness, transcript = witness_of(circuit, params.n, seed)
    pk = keygen(params, cs, fixed)
    torch.cuda.synchronize()

    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        proof = create_proof(params, pk, [], witness, seed=seed, transcript=transcript())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    launches = kernels.launch_counts()
    if not verify_proof(params, pk.vk, [], proof, transcript=transcript()):
        raise AssertionError(f"the profiled {circuit} proof does not verify")

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
    print(f"{circuit} create_proof k={k}: wall {wall:.2f} s, device busy {busy:.2f} s, "
          f"idle share {1 - busy / wall:.3f}")
    print(f"launch counts: {json.dumps(launches)}")
    for name, (sec, count) in rows[:25]:
        print(f"  {sec:9.3f} s {count:8d}x  {name[:110]}")
    tag = "" if circuit == "keccak_table" else "mpt_"
    out = ROOT / "build" / f"profile_{tag}k{k}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({
        "circuit": circuit, "k": k, "wall_s": wall, "device_busy_s": busy, "launches": launches,
        "kernels": [{"name": k, "seconds": v[0], "count": v[1]} for k, v in rows],
    }, indent=1))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from zkevm_tpu_torch import kernels
    from zkevm_tpu_torch.kzg import ParamsKZG

    if not torch.cuda.is_available():
        print("profile_torch_proof: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    kernels.build_all()
    params = ParamsKZG.unsafe_setup(chip_smoke.MAIN_K, device="cuda")
    for circuit in ("keccak_table", "mpt"):
        profile_proof(circuit, params, args.seed)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
