"""Reduce a ``torch.profiler`` window to what the per-layer metrics read.

The arithmetic is that of the port's ``utils/profiling.device_breakdown``
(copied here, so that a change to the program cannot move the
yardstick): device time by kernel name and by the ``record_function``
region its launch started in, the union of the device's busy intervals,
and a refusal of a window whose trace lost a launch's device record.
Added here: the device's idle gaps, each named by the innermost region
the host was in when the gap began.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity


@contextlib.contextmanager
def profile(warmup: int = 1):
    """Trace CPU and CUDA activity. The caller calls ``prof.step()`` after
    each step with the device idle; the first ``warmup`` steps are traced
    and thrown away: a profiler session can lose the device records of
    the first kernels it sees."""
    schedule = torch.profiler.schedule(wait=0, warmup=warmup, active=1 << 30)
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                schedule=schedule) as prof:
        yield prof


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(prof) -> Dict[str, object]:
    """``ms_by_op`` {kernel: ms}, ``calls_by_op``, ``ms_by_region`` {region:
    device ms launched inside it}, ``busy_ms`` (union of device
    intervals), ``wall_ms`` (the traced window, first to last event),
    ``gaps`` [(label, ms)] longest first, ``launches``. Raises when the
    trace holds no device time or lost a launch's device record."""
    events = [e for e in prof.events() if not e.is_async]
    regions = [e for e in events if e.device_type == DeviceType.CPU and e.is_user_annotation]
    names = {r.name for r in regions}
    device_ops = [e for e in events if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation and e.name not in names]
    if not any(e.time_range.elapsed_us() > 0 for e in device_ops):
        raise RuntimeError("the trace holds no device time (CUPTI tracing missing?)")
    api = {e.id: e.time_range.start for e in events
           if e.device_type == DeviceType.CPU and e.name.startswith("cu")}
    recorded = {d.id for d in device_ops}
    calls = [e.id for e in events if e.device_type == DeviceType.CPU and "LaunchKernel" in e.name]
    dropped = sum(1 for i in calls if i not in recorded)
    if dropped:
        raise RuntimeError(f"{dropped} of the window's {len(calls)} kernel launches have no "
                           "device record: the trace lost them")
    by_op: Dict[str, float] = defaultdict(float)
    n_op: Dict[str, int] = defaultdict(int)
    by_region: Dict[str, float] = defaultdict(float)
    spans = [(r.time_range.start, r.time_range.end, r.name) for r in regions]
    for d in device_ops:
        us = d.time_range.elapsed_us()
        by_op[d.name] += us
        n_op[d.name] += 1
        start = api.get(d.id)
        if start is None:
            by_region["unlinked"] += us
            continue
        inside = {n for a, b, n in spans if a <= start <= b}
        for n in inside or ("unannotated",):
            by_region[n] += us
    busy = _union([(d.time_range.start, d.time_range.end) for d in device_ops])
    t0 = min(e.time_range.start for e in events)
    t1 = max(e.time_range.end for e in events)
    gaps = []
    for (_, a), (b, _) in zip(busy, busy[1:]):
        # the innermost region open on the host when the device fell idle
        open_ = [(s, n) for s, e, n in spans if s <= a <= e]
        label = max(open_)[1] if open_ else "outside any region"
        gaps.append((label, (b - a) / 1e3))
    gaps.sort(key=lambda g: -g[1])
    return {
        "ms_by_op": {k: v / 1e3 for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])},
        "calls_by_op": dict(n_op),
        "ms_by_region": {k: v / 1e3 for k, v in by_region.items()},
        "busy_ms": sum(b - a for a, b in busy) / 1e3,
        "wall_ms": (t1 - t0) / 1e3,
        "gaps": gaps,
        "launches": len(calls),
    }


def breakdown(r: Dict[str, object], n: int = 10) -> Dict[str, list]:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps, in seconds."""
    ops = list(r["ms_by_op"].items())[:n]
    return {"device_ops": [[k, v / 1e3] for k, v in ops],
            "idle_gaps": [[k, v / 1e3] for k, v in r["gaps"][:n]]}
