"""Offline dataset tools of the port (counterpart of ``esr_tpu.tools``):
datalist generation, HDF5 packagers, the event simulator and converters."""

from esr_tpu_torch.tools.datalist import generate_datalist, write_txt
from esr_tpu_torch.tools.packagers import H5LadderPackager, H5Packager
from esr_tpu_torch.tools.simulate import (
    EventSimulator,
    convert_eventzoom,
    sample_contrast_thresholds,
    simulate_ladder_recording,
)

__all__ = [
    "generate_datalist",
    "write_txt",
    "H5Packager",
    "H5LadderPackager",
    "EventSimulator",
    "convert_eventzoom",
    "sample_contrast_thresholds",
    "simulate_ladder_recording",
]
