"""tdeed_tpu_torch — T-DEED precise event spotting in PyTorch for NVIDIA
Hopper GPUs.

The port of ``tdeed_tpu`` (JAX on a TPU), which stays the reference it is
tested against. Module layout mirrors ``tdeed_tpu`` (models/, ops/,
kernels/, train/, utils/, tools/), so each module's counterpart is easy to
find. Plain tensor code is PyTorch; each of the JAX package's Pallas
kernels is a hand-written CUDA kernel (csrc/), built with nvcc at first
use. The config system is the port's own copy, ``tdeed_tpu_torch.config``.
The port imports nothing of jax or of ``tdeed_tpu``; its entry points run
on the CUDA device unless the caller asks for the CPU.
"""

from tdeed_tpu_torch.config import TDEEDConfig, load_config  # noqa: F401
