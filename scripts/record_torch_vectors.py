"""Record reference proofs from the JAX package for the PyTorch port.

Usage: python scripts/record_torch_vectors.py

Runs ``zkevm_tpu`` on the CPU and writes
``tests/vectors/torch_port_toy_proof.json``: for the K=5 toy circuit of
``tests/test_plonk.py`` and for a two-phase toy circuit with one
challenge (both from ``zkevm_tpu_torch/circuits/toy.py``, built with the
reference's own classes), the SRS tau, the instances, the blinding seed,
the verifying key's commitments and every field of the ``Proof``.
``chip_smoke.py`` holds the GPU port's proofs against this file (the GPU
machine has no JAX), and ``tests/port/test_torch_vectors.py`` checks that the
file still equals what this script produces.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "tests" / "vectors" / "torch_port_toy_proof.json"
TAU = 0xDEAD_BEEF_CAFE  # the reference's default unsafe_setup tau
TOY_SEED = 7
TWO_PHASE_SEED = 11


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


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    OUT.write_text(json.dumps(record(), indent=1) + "\n")
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
