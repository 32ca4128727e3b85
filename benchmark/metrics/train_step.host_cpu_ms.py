"""Host CPU ms a training step takes to issue its work: over the steps in
the program's ring of step records (utils/profiling.py ``STEPS``, the
last 256) that ran with no profiler recording, each the step's thread's
CPU over the step plus the autograd engine's worker thread's over its
backward segments, the mean of those between the first and third
quartile. The card's machine reads a thread's CPU in 10 ms ticks, so a
median would move in 10 ms steps; the interquartile mean keeps its
indifference to the cold set-up steps and resolves far finer. None where
the program keeps no such record."""

import statistics


def read(r):
    from tdeed_tpu_torch.utils import profiling

    steps = getattr(profiling, "STEPS", None)
    ms = [rec.host_cpu_ns / 1e6 for rec in getattr(steps, "records", ()) if not rec.profiled]
    if len(ms) < 2:
        return ms[0] if ms else None
    q1, _, q3 = statistics.quantiles(ms, n=4)
    return statistics.mean(v for v in ms if q1 <= v <= q3)
