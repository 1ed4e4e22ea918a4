"""Utilities of the port (counterpart of ``esr_tpu.utils``)."""

from esr_tpu_torch.utils.timers import Timer, print_timing_info, timing_stats

__all__ = ["Timer", "timing_stats", "print_timing_info"]
