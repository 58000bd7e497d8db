"""Prover orchestration layer: artifact (de)serialization and
load-or-generate caching (host copies)."""

from zkevm_tpu_torch.prover.artifacts import (
    dump_proof,
    load_or_gen_proof,
    load_proof,
    proof_from_bytes,
    proof_to_bytes,
    vk_fingerprint,
)

__all__ = [
    "dump_proof",
    "load_or_gen_proof",
    "load_proof",
    "proof_from_bytes",
    "proof_to_bytes",
    "vk_fingerprint",
]
