"""The share of an untraced training step in which the device runs
nothing: 1 - device busy a step (the union of kernel intervals in the
trace) / the untraced window's seconds a step."""


def read(r):
    busy_s = r["trace"]["busy_ms"] / 1e3 / r["units_traced"]
    return 100.0 * (1.0 - busy_s / r["unit_s"])
