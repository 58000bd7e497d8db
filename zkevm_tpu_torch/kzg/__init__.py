"""KZG layer: SRS params, device commitments, opens, host verification."""

from zkevm_tpu_torch.kzg.params import ParamsKZG, open_single, verify_single

__all__ = ["ParamsKZG", "open_single", "verify_single"]
