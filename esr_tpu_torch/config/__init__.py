"""Configs of the port (counterpart of ``esr_tpu.config``)."""
