"""Device ms a training step spends in the trunk's squeeze-and-excitation
kernels (tdeed_tpu_torch/csrc/se.cu: every kernel whose name holds
``tdeed_se_``), per step. None where the program launches none."""


def read(r):
    ms = [v for k, v in r["trace"]["ms_by_op"].items() if "tdeed_se_" in k]
    return sum(ms) / r["units_traced"] if ms else None
