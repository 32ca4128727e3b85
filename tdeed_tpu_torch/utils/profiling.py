"""Profiling hooks (port of tdeed_tpu/utils/profiling.py): torch.profiler
traces and per-step wall-clock timers.

``trace(logdir, device)`` wraps a region in a ``torch.profiler`` capture
and writes a Chrome trace (Perfetto, chrome://tracing) under ``logdir``;
``annotate`` names a region inside it; ``StepTimer`` aggregates per-step
latencies with jitter stats; ``time_fn`` times a call on the card with
CUDA events; ``bound`` is the card's least time for a given work.

The JAX package's ``enable_compilation_cache`` has no counterpart: the
port runs eagerly, with no XLA program to compile and cache, and its CUDA
kernels are built once per source into build/kernels/ (kernels/build.py).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12  # tensor cores
PEAK_FP32_FLOPS = 67e12  # CUDA cores


def bound(moved_bytes: float, ops: float, ops_per_s: float) -> Tuple[float, str]:
    """The least time in ms an H100 could take for work that must move
    ``moved_bytes`` (each input read once, each output written once) and
    do ``ops`` operations at ``ops_per_s``: the larger of the two times,
    and which of them it is ("bytes" or "operations")."""
    t_bytes = moved_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def trace(logdir: Optional[str], device="cuda"):
    """Capture a ``torch.profiler`` trace of the enclosed region and yield
    the profiler (``key_averages()`` once the region has ended). CPU
    activity always; CUDA activity (kernel times from CUPTI) when
    ``device`` is a CUDA device, that is, when the traced tensors are on
    the card. On exit the Chrome trace is written to
    ``<logdir>/trace.json``; with ``logdir`` None, nowhere."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    if logdir is not None:
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region inside a trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timer with percentile summary.

    Use ``with timer.step(): run()`` around each training step; the step's
    device work must be waited for inside the region (``float(loss)`` or
    ``torch.cuda.synchronize()``) for honest numbers.
    """

    def __init__(self):
        self.samples: List[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        yield
        self.samples.append(time.perf_counter() - t0)

    def summary(self, skip_warmup: int = 2) -> Dict[str, float]:
        s = sorted(self.samples[skip_warmup:])
        if not s:
            # no measured steps: report emptiness, never a fake 0.0s step
            return {"steps": 0, "mean_s": float("nan"), "p50_s": float("nan"),
                    "p90_s": float("nan"), "min_s": float("nan"),
                    "max_s": float("nan")}
        n = len(s)
        return {
            "steps": n,
            "mean_s": sum(s) / n,
            "p50_s": s[n // 2],
            "p90_s": s[int(n * 0.9)],
            "min_s": s[0],
            "max_s": s[-1],
        }


def time_fn(fn, *args, device="cuda", warmup: int = 2, iters: int = 10,
            **kwargs) -> float:
    """Mean seconds per call of ``fn(*args, **kwargs)``.

    On a CUDA ``device``: CUDA events around ``iters`` calls, after the
    warm-up and a ``synchronize()``, so the time is the card's, not the
    enqueue's. On the CPU: ``perf_counter`` around the calls."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kwargs)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args, **kwargs)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
