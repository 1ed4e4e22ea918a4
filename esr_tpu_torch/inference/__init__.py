"""Evaluation of the port (counterpart of ``esr_tpu.inference``)."""
