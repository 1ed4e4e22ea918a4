"""Ops of the port (counterpart of ``esr_tpu.ops``)."""
