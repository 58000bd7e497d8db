"""Hash layer: Keccak-f[1600] and keccak256 on torch tensors."""

from zkevm_tpu_torch.hash import keccak
from zkevm_tpu_torch.hash.keccak import keccak256, keccak256_batch, keccak_f

__all__ = ["keccak", "keccak256", "keccak256_batch", "keccak_f"]
