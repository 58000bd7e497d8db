"""Finite-field layer: BN254 Fr/Fq as (..., 8) int32 Montgomery words."""

from zkevm_tpu_torch.ff import field, goldens
from zkevm_tpu_torch.ff.field import FQ, FR, FieldSpec

__all__ = ["FR", "FQ", "FieldSpec", "field", "goldens"]
