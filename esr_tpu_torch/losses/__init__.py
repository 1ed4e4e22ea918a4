"""Losses and metrics of the port (counterpart of ``esr_tpu.losses``)."""

from esr_tpu_torch.losses.flow import averaged_iwe, event_warping_loss
from esr_tpu_torch.losses.reconstruction import BrightnessConstancy

__all__ = ["event_warping_loss", "averaged_iwe", "BrightnessConstancy"]
