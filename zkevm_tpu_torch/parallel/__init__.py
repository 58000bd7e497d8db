"""Multi-device layer: the process mesh and the sharded MSMs and NTTs over
``torch.distributed`` (NCCL on GPUs, gloo on CPU processes)."""

from zkevm_tpu_torch.parallel.mesh import default_mesh, sharded_msm, sharded_ntt_batch

__all__ = ["default_mesh", "sharded_msm", "sharded_ntt_batch"]
