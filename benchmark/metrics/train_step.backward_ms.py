"""Device ms a training step spends in kernels launched inside the
step's ``backward`` region (train/step.py), per optimizer step."""


def read(r):
    ms = r["trace"]["ms_by_region"].get("backward")
    return None if ms is None else ms / r["units_traced"]
