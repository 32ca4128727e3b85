"""Device ms a training step spends in kernels launched inside the
model's ``trunk`` region (models/tdeed.py: the RegNet-Y GSF forward), per
step."""


def read(r):
    ms = r["trace"]["ms_by_region"].get("trunk")
    return None if ms is None else ms / r["units_traced"]
