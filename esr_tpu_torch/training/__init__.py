"""Training of the port (counterpart of ``esr_tpu.training``)."""
