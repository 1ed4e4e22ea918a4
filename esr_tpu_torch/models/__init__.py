"""Models of the port (counterpart of ``esr_tpu.models``)."""
