"""Ops of the port (counterpart of ``esr_tpu.ops``)."""

from esr_tpu_torch.ops.psroi import deform_psroi_pooling

__all__ = ["deform_psroi_pooling"]
