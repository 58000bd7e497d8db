"""Hash layer: Keccak-f[1600] and keccak256, and Poseidon, on torch tensors."""

from zkevm_tpu_torch.hash import keccak, poseidon
from zkevm_tpu_torch.hash.keccak import keccak256, keccak256_batch, keccak_f
from zkevm_tpu_torch.hash.poseidon import P128_POW5_T3, PoseidonSpec, permute

__all__ = [
    "keccak",
    "poseidon",
    "keccak256",
    "keccak256_batch",
    "keccak_f",
    "P128_POW5_T3",
    "PoseidonSpec",
    "permute",
]
