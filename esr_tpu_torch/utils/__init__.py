"""Utilities of the port (counterpart of ``esr_tpu.utils``)."""

from esr_tpu_torch.utils.logging import setup_logging
from esr_tpu_torch.utils.pipeline_vis import PipelineVisualizer, flow_to_image, minmax_norm
from esr_tpu_torch.utils.timers import Timer, print_timing_info, timing_stats

__all__ = [
    "Timer",
    "timing_stats",
    "print_timing_info",
    "setup_logging",
    "PipelineVisualizer",
    "flow_to_image",
    "minmax_norm",
]
