"""Profiling hooks (port of tdeed_tpu/utils/profiling.py): torch.profiler
traces and per-step wall-clock timers.

``trace(logdir, device)`` wraps a region in a ``torch.profiler`` capture
and writes a Chrome trace (Perfetto, chrome://tracing) under ``logdir``;
``annotate`` names a region inside it, and ``device_breakdown`` reduces
a trace to time by op and by region and the busy and idle share (the
counterpart of tools/profile_trace.py's ``parse_trace`` and
tools/trace_attrib.py); ``StepTimer`` times steps on the host clock
(synchronizing the card around each) with jitter stats; ``time_fn`` times
a call on the card with CUDA events; ``card`` names the card; ``bound``
is the card's least time for a given work.

The JAX package's ``enable_compilation_cache`` has no counterpart: the
port runs eagerly, with no XLA program to compile and cache, and its CUDA
kernels are built once per source into build/kernels/ (kernels/build.py).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import subprocess
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import DeviceType
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
def trace(logdir: Optional[str], device="cuda", warmup: int = 0):
    """Capture a ``torch.profiler`` trace of the enclosed region and yield
    the profiler (``events()`` once the region has ended). CPU activity
    always; CUDA activity (kernel times from CUPTI) when ``device`` is a
    CUDA device, that is, when the traced tensors are on the card. On exit
    the Chrome trace is written to ``<logdir>/trace.json``; with ``logdir``
    None, nowhere.

    With ``warmup`` > 0 the caller calls ``prof.step()`` after each step,
    with the card idle: the first ``warmup`` steps are traced and thrown
    away, and the trace holds the steps after them. A profiler session
    after the first in a process can lose the device records of the
    kernels it launches first (seen on the H100 with CUPTI); the
    thrown-away step takes that loss, which ``device_breakdown`` counts as
    ``dropped``."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
    schedule = (torch.profiler.schedule(wait=0, warmup=warmup, active=1 << 30)
                if warmup else None)
    with torch.profiler.profile(activities=activities, schedule=schedule) as prof:
        yield prof
    if logdir is not None:
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region inside a trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timer with percentile summary.

    Use ``with timer.step(): run()`` around each training step. With a
    CUDA ``device`` each step starts and ends in ``torch.cuda.synchronize``,
    so it times the step's device work from an idle card; otherwise that
    work must be waited for inside the region (``float(loss)``) for honest
    numbers.
    """

    def __init__(self, device=None):
        self.samples: List[float] = []
        self._sync = device is not None and torch.device(device).type == "cuda"
        self._device = device

    @contextlib.contextmanager
    def step(self):
        if self._sync:
            torch.cuda.synchronize(self._device)
        t0 = time.perf_counter()
        yield
        if self._sync:
            torch.cuda.synchronize(self._device)
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

    def ms(self) -> Dict[str, float]:
        """Every step's time in ms: median, min, max and count."""
        if not self.samples:
            raise ValueError("StepTimer.ms: no steps timed")
        ms = [s * 1e3 for s in self.samples]
        return {"median": statistics.median(ms), "min": min(ms), "max": max(ms), "n": len(ms)}


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


def card() -> Dict[str, object]:
    """The card: its name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them for
    the first card (``smi``, the line as printed), and the device count.
    Raises where nvidia-smi is missing or fails."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, power_limit = (f.strip() for f in smi.rsplit(",", 1))
    return {"name": name, "power_limit": power_limit, "count": torch.cuda.device_count(),
            "smi": smi}


def platform(tool: str, device) -> Dict[str, object]:
    """What a measuring tool's JSON says it ran on: ``{"platform": "gpu",
    "card": card()}`` on a CUDA ``device``, ``{"platform": "cpu", "card":
    None}`` on the CPU. A CUDA ``device`` without a card exits non-zero
    (SystemExit naming ``tool``): no measurement falls back to the CPU."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "card": None}
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device (torch.cuda.is_available() is False); "
                         "pass --device cpu to run the plain versions at a tiny size")
    return {"platform": "gpu", "card": card()}


def peak_gib(device) -> Optional[float]:
    """The CUDA allocator's peak since the last ``reset_peak(device)``, in
    GiB; None on the CPU, which has no device memory to measure."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def reset_peak(device) -> None:
    """Start a new peak for ``peak_gib`` on a CUDA ``device``, after
    releasing the allocator's cached blocks; nothing on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _union_us(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_breakdown(prof, device="cuda", top: int = 20,
                     always: Sequence[str] = ()) -> Dict[str, object]:
    """Reduce a ``torch.profiler`` window (``trace``) to where its time
    went:

      ``ms_by_op``      time by op, the ``top`` ops with the most and any
                        op whose name holds a string of ``always``, each
                        {"ms", "calls"};
      ``ms_by_region``  time of the ops started inside each ``annotate``
                        region, by region name (a nested region counts in
                        both; ops outside every region under "unannotated",
                        device ops whose launch the trace does not show
                        under "unlinked");
      ``wall_ms``       the window, from its first event's start to its
                        last event's end;
      ``busy_ms``, ``busy_share``, ``idle_share``  the union of the ops'
                        intervals, and its share of the window and the rest;
      ``launches``, ``dropped``  on the card, the kernel launch calls in
                        the window and those of them with no device record.

    On a CUDA ``device`` the ops are the device's kernels, copies and fills
    and their device time; a kernel counts in the regions its launch
    started in, on whichever host thread (the backward runs on the
    autograd engine's). A window with no device time raises: the card's
    trace is then missing, not idle. So does a window that lost a launched
    kernel's device record (``dropped`` > 0): its busy time would be short
    and its idle share long (trace with ``warmup``). On the CPU the ops
    are the host's PyTorch ops and their self time, the plain versions'
    work, ``platform`` says "cpu" and ``launches``/``dropped`` are None."""
    events = [e for e in prof.events() if not e.is_async]
    regions = [e for e in events if e.device_type == DeviceType.CPU and e.is_user_annotation]
    names = {r.name for r in regions}
    on_card = torch.device(device).type == "cuda"
    launches = dropped = None
    if on_card:
        device_ops = [e for e in events if e.device_type == DeviceType.CUDA
                      and not e.is_user_annotation and e.name not in names]
        ops = [(e.name, e.time_range.start, e.time_range.end, e.time_range.elapsed_us())
               for e in device_ops]
        if not any(us > 0 for *_, us in ops):
            raise RuntimeError("device_breakdown: the trace holds no device time on the card "
                               "(CUPTI tracing missing?)")
        # the host time each device op was launched at: the start of the
        # CUDA API call with its correlation id (cudaLaunchKernel from
        # PyTorch, cudaLaunchKernelExC from K1's own library and cuDNN,
        # cuLaunchKernel, a copy's cudaMemcpyAsync)
        api = {e.id: e.time_range.start for e in events
               if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
        launched = [(api.get(d.id), d.time_range.elapsed_us()) for d in device_ops]
        # every kernel launch call makes one device record with its id
        recorded = {d.id for d in device_ops}
        calls = [e.id for e in events
                 if e.device_type == DeviceType.CPU and "LaunchKernel" in e.name]
        launches = len(calls)
        dropped = sum(1 for i in calls if i not in recorded)
        if dropped:
            raise RuntimeError(
                f"device_breakdown: {dropped} of the window's {launches} kernel launches have "
                "no device record: the trace lost them, so its busy time is short (trace "
                "with warmup=1)")
    else:
        ops = [(e.name, e.time_range.start, e.time_range.end, e.self_cpu_time_total)
               for e in events if e.device_type == DeviceType.CPU and not e.is_user_annotation]
        launched = [(start, us) for _, start, _, us in ops]
    by_op, calls_by_op = defaultdict(float), defaultdict(int)
    for name, _, _, us in ops:
        by_op[name] += us
        calls_by_op[name] += 1
    by_region = defaultdict(float)
    for start, us in launched:
        if start is None:
            by_region["unlinked"] += us
            continue
        inside = {r.name for r in regions if r.time_range.start <= start <= r.time_range.end}
        for name in inside or ("unannotated",):
            by_region[name] += us
    for name in names:
        by_region.setdefault(name, 0.0)
    spans = [(e.time_range.start, e.time_range.end) for e in events]
    wall = max(b for _, b in spans) - min(a for a, _ in spans)
    busy = _union_us([(a, b) for _, a, b, _ in ops])
    ranked = sorted(by_op, key=lambda k: -by_op[k])
    ranked = ranked[:top] + [k for k in ranked[top:] if any(a in k for a in always)]
    return {
        "platform": "gpu" if on_card else "cpu",
        "ms_by_op": {k: {"ms": by_op[k] / 1e3, "calls": calls_by_op[k]} for k in ranked},
        "ms_by_region": {k: v / 1e3 for k, v in sorted(by_region.items())},
        "wall_ms": wall / 1e3,
        "busy_ms": busy / 1e3,
        "busy_share": busy / wall if wall > 0 else 0.0,
        "idle_share": 1.0 - busy / wall if wall > 0 else 1.0,
        "launches": launches,
        "dropped": dropped,
    }
