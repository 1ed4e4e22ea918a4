"""The serving tier of the port: continuous-batched lanes over the streaming
engine (counterpart of ``esr_tpu/serving``, single replica)."""
