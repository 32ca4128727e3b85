"""Device ms a training step spends in kernels launched inside the
model's ``backward.trunk`` region (models/tdeed.py: from the gradient
reaching the trunk's output to the end of the backward, on the thread
that runs it: the RegNet-Y GSF backward), per step. None where the
program opens no such region."""


def read(r):
    ms = r["trace"]["ms_by_region"].get("backward.trunk")
    return None if ms is None else ms / r["units_traced"]
