"""Device ms a training step spends in kernels launched inside the
model's ``backward.temporal`` region (models/tdeed.py: from the gradient
reaching the temporal layer's output to the trunk's, on the thread that
runs the backward: the SGP-Mixer's and the temporal embedding's
backward), per step. None where the program opens no such region."""


def read(r):
    ms = r["trace"]["ms_by_region"].get("backward.temporal")
    return None if ms is None else ms / r["units_traced"]
