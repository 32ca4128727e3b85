"""The training step's model FLOPs (forward counted by the reference at
the cell's shapes, the backward as twice the forward, recomputed work not
counted) over the untraced window's seconds a step, as a share of the
H100's 989 TFLOP/s of dense bf16."""

from benchmark.roofline import PEAK_BF16_FLOPS


def read(r):
    return 100.0 * r["flops_per_step"] / r["unit_s"] / PEAK_BF16_FLOPS
