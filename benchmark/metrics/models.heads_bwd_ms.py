"""Device ms a training step spends in kernels launched inside the
model's ``backward.heads`` region (models/tdeed.py: from the first
gradient reaching the model's outputs to the temporal layer's output, on
the thread that runs the backward: the class and displacement heads'
backward), per step. None where the program opens no such region."""


def read(r):
    ms = r["trace"]["ms_by_region"].get("backward.heads")
    return None if ms is None else ms / r["units_traced"]
