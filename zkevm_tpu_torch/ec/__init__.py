"""Elliptic-curve layer: BN254 G1 group ops and the commitment MSMs."""

from zkevm_tpu_torch.ec import goldens, group, msm, pippenger

__all__ = ["goldens", "group", "msm", "pippenger"]
