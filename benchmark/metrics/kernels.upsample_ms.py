"""Device ms a training step spends in the SGP-Mixer's linear upsample,
forward and backward: every kernel whose name holds ``upsample_linear1d``
(ATen's) or ``tdeed_upsample`` (tdeed_tpu_torch/csrc/upsample.cu), per
step. None where the program launches neither."""


def read(r):
    ms = [v for k, v in r["trace"]["ms_by_op"].items()
          if "upsample_linear1d" in k or "tdeed_upsample" in k]
    return sum(ms) / r["units_traced"] if ms else None
