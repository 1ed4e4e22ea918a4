"""Losses and metrics of the port (counterpart of ``esr_tpu.losses``)."""
