"""K1's share of its roofline: the least time its bytes take at the
H100's 3.35 TB/s (benchmark/roofline.py, at the launch's shape) over its
device time a launch, the kernel found in the trace by its name."""

from benchmark.roofline import k1_least_s


def read(r):
    ops = [(ms, r["trace"]["calls_by_op"][k]) for k, ms in r["trace"]["ms_by_op"].items()
           if "photometric_kernel" in k]
    if not ops:
        return None
    ms = sum(m for m, _ in ops) / sum(n for _, n in ops)
    return 100.0 * k1_least_s(r["k1_shape"], r["k1_in_bytes"]) * 1e3 / ms
