"""tdeed_tpu_torch — T-DEED precise event spotting in PyTorch for NVIDIA
Hopper GPUs.

The port of ``tdeed_tpu`` (JAX on a TPU), which stays the reference it is
tested against. Module layout mirrors ``tdeed_tpu`` (models/, ops/,
kernels/, train/), so each module's counterpart is easy to find. Plain
tensor code is PyTorch; the JAX package's Pallas kernel is a hand-written
CUDA kernel (csrc/), built with nvcc at first use. The config system is
the JAX package's own JAX-free ``tdeed_tpu.config``, reused by import.
The port never imports jax.
"""

from tdeed_tpu.config import TDEEDConfig, load_config  # noqa: F401
