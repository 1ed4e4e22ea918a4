"""Utilities of the port (counterpart of ``esr_tpu.utils``)."""
