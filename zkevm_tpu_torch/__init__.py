"""PyTorch / CUDA port of the zkevm_tpu proving stack for NVIDIA Hopper.

The JAX package ``zkevm_tpu`` stays the reference; this package keeps its
module names so each counterpart is easy to find, imports ``torch`` and never
``jax`` or ``zkevm_tpu``. Device kernels are hand-written CUDA C++ in
``csrc/`` (see ``kernels.py``); every wrapper runs its kernel on a CUDA
tensor and its plain PyTorch version on a CPU tensor.
"""

from zkevm_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
