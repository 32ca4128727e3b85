"""tdeed_tpu_torch — T-DEED precise event spotting in PyTorch for NVIDIA
Hopper GPUs.

The port of ``tdeed_tpu`` (JAX on a TPU), which stays the reference it is
tested against. Module layout mirrors ``tdeed_tpu`` (models/, ops/,
kernels/, train/, data/, infer/, metrics/, utils/, tools/), so each
module's counterpart is easy to find. Plain tensor code is PyTorch; each of
the JAX package's Pallas kernels is a hand-written CUDA kernel (csrc/),
built with nvcc at first use. The JAX-free host modules are the port's own
copies: ``config``, the dataset registry, frame reads and the frame cache
(data/), window enumeration, NMS and the evaluation protocol (infer/), the
tolerance mAP and the SoccerNet scorers (metrics/) and the JSON writers
(utils/io.py). On them sit sliding-window inference and serving,
``infer.predictor.SpottingPredictor``, the ``torch.export`` serving
artifact (``infer.export``) and the CLIs (cli/: train, predict,
evaluate_challenge, export_model).
The port imports nothing of jax or of ``tdeed_tpu``; its entry points run
on the CUDA device unless the caller asks for the CPU.
"""

from tdeed_tpu_torch.config import TDEEDConfig, load_config  # noqa: F401
