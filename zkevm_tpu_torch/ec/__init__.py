"""Elliptic-curve layer: BN254 G1 group ops and the commitment MSM."""

from zkevm_tpu_torch.ec import goldens, group, msm

__all__ = ["goldens", "group", "msm"]
