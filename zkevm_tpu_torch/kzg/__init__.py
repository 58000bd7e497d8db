"""KZG layer: SRS params and device commitments."""

from zkevm_tpu_torch.kzg.params import ParamsKZG

__all__ = ["ParamsKZG"]
