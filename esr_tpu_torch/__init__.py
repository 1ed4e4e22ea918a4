"""PyTorch/CUDA port of ``esr_tpu`` for NVIDIA Hopper.

The JAX package ``esr_tpu`` is the reference; this package mirrors its
module layout (``models/``, ``ops/``, ``data/``, ``losses/``, ``utils/``,
``inference/``) and never imports it, nor JAX. Public seams keep the
reference's channel-last layouts so the two can be compared like for like;
inside the model the convolutions run NCHW.

Entry points run on the CUDA card by default (``device.resolve_device``);
the CPU is used only when asked for by name.
"""

from esr_tpu_torch.device import apply_numerics_policy, resolve_device

__all__ = ["apply_numerics_policy", "resolve_device"]
