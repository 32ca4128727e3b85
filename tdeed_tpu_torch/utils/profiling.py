"""Profiling hooks (port of tdeed_tpu/utils/profiling.py): torch.profiler
traces and per-step wall-clock timers.

``trace(logdir, device)`` wraps a region in a ``torch.profiler`` capture
and writes a Chrome trace (Perfetto, chrome://tracing) under ``logdir``;
``annotate`` names a region inside it, and ``device_breakdown`` reduces
a trace to time by op and by region and the device's busy time (the
counterpart of tools/profile_trace.py's ``parse_trace`` and
tools/trace_attrib.py). ``STEPS`` keeps the host record of the last 256
training steps: while a step runs, each ``annotate`` region and each
backward segment (``BackwardSegments``, the model's ``backward.heads``,
``backward.temporal`` and ``backward.trunk``) is a span of it with its
thread's CPU time, the record sums the step's host CPU, and it counts the
model's layers replayed from CUDA graphs and run eagerly; it is always
on, kept in memory, and written out only on request (``record_json``).
``StepTimer`` times steps on the host clock
(synchronizing the card around each) with jitter stats; ``time_fn`` times
a call on the card with CUDA events; ``card`` names the card; ``bound``
is the card's least time for a given work.

The JAX package's ``enable_compilation_cache`` has no counterpart: the
port runs eagerly, with no XLA program to compile and cache, and its CUDA
kernels are built once per source into build/kernels/ (kernels/build.py).
"""

from __future__ import annotations

import collections
import contextlib
import os
import statistics
import subprocess
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

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
    """Named region inside a trace. While a training step's record is open
    (``STEPS``) the region also adds a span to it."""
    rec = STEPS.open
    if rec is None:
        return torch.profiler.record_function(name)
    return _Region(rec, name)


# --- the host record of each training step ---------------------------------

RING_STEPS = 256


@dataclass(slots=True)
class Span:
    """One region of a training step on the host: its ``name``; ``parent``,
    the index of the span it opened inside (the innermost open on its own
    thread, else on the step's thread) or None; ``thread``, its thread's
    ``threading.get_ident()``; ``start_ns`` and ``end_ns`` on the Unix clock
    (``time.time_ns``), the profiler's: a trace's events are microseconds
    after ``kineto_results.trace_start_ns()``; ``cpu_ns``, the CPU time its
    thread used over it."""

    name: str
    parent: Optional[int]
    thread: int
    start_ns: int
    end_ns: int = 0
    cpu_ns: int = 0
    cpu0_ns: int = field(default=0, repr=False)  # the thread's CPU clock at the start


@dataclass
class StepRecord:
    """The host record of one training step (``TrainStep.__call__``): its
    spans in the order they opened; ``thread``, the step's thread;
    ``main_cpu_ns``, that thread's CPU over the step; ``worker_cpu_ns``,
    the CPU of other threads over their outermost spans (the autograd
    engine's worker over the backward segments on the card); ``profiled``,
    whether a ``torch.profiler`` session recorded regions at the step's
    start or end (the warm-up steps of a scheduled session record none and
    read False); ``graph_layers`` and ``eager_layers``, the model's layers
    its training forwards replayed from CUDA graphs and ran eagerly
    (models/graphs.py), three a forward."""

    thread: int
    start_ns: int
    profiled: bool
    spans: List[Span] = field(default_factory=list)
    end_ns: int = 0
    main_cpu_ns: int = 0
    worker_cpu_ns: int = 0
    graph_layers: int = 0
    eager_layers: int = 0
    _stacks: Dict[int, List[int]] = field(default_factory=dict, repr=False)

    @property
    def host_cpu_ns(self) -> int:
        return self.main_cpu_ns + self.worker_cpu_ns

    def open_span(self, name: str) -> int:
        thread = threading.get_ident()
        stack = self._stacks.get(thread)
        if stack is None:
            stack = self._stacks[thread] = []
        outer = stack or self._stacks.get(self.thread)
        i = len(self.spans)
        self.spans.append(Span(name, outer[-1] if outer else None, thread, time.time_ns(),
                               cpu0_ns=time.thread_time_ns()))
        stack.append(i)
        return i

    def close_span(self, i: int) -> None:
        """Close span ``i``, from any thread (its CPU is its own thread's)."""
        span = self.spans[i]
        if threading.get_ident() == span.thread:
            cpu = time.thread_time_ns()
        else:
            cpu = time.clock_gettime_ns(time.pthread_getcpuclockid(span.thread))
        span.cpu_ns = cpu - span.cpu0_ns
        span.end_ns = time.time_ns()
        stack = self._stacks[span.thread]
        stack.remove(i)
        if span.thread != self.thread and not stack:
            self.worker_cpu_ns += span.cpu_ns


class _Region:
    """``annotate``'s region while a step record is open: the profiler
    region and, inside it, a span of the record."""

    __slots__ = ("rec", "name", "rf", "i")

    def __init__(self, rec: StepRecord, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.i = self.rec.open_span(self.name)
        return self

    def __exit__(self, *exc):
        self.rec.close_span(self.i)
        self.rf.__exit__(*exc)


class StepRecorder:
    """The host records of training steps: ``record()`` around a step opens
    a StepRecord that ``annotate`` regions and backward segments add spans
    to; ``records`` keeps the last ``maxlen`` steps, in memory (a step that
    raises leaves none)."""

    def __init__(self, maxlen: int = RING_STEPS):
        self.records: Deque[StepRecord] = collections.deque(maxlen=maxlen)
        self.open: Optional[StepRecord] = None

    @contextlib.contextmanager
    def record(self):
        profiled = torch.autograd.profiler._is_profiler_enabled
        rec = StepRecord(threading.get_ident(), time.time_ns(), profiled)
        cpu = time.thread_time_ns()
        self.open = rec
        try:
            yield rec
        finally:
            self.open = None
        rec.main_cpu_ns = time.thread_time_ns() - cpu
        rec.end_ns = time.time_ns()
        rec.profiled = profiled or torch.autograd.profiler._is_profiler_enabled
        self.records.append(rec)

    def count_layers(self, graphed: int, eager: int) -> None:
        """Count a forward's layers replayed from graphs and run eagerly
        in the open record, if a step is open."""
        if self.open is not None:
            self.open.graph_layers += graphed
            self.open.eager_layers += eager


# every training step's record (train/step.py), read by the benchmark's
# train_step.host_cpu_ms and by tools/profile_step.py
STEPS = StepRecorder()


class BackwardSegments:
    """Profiler regions over one backward pass, one a model layer:
    ``mark(t, name)`` on a forward tensor opens region ``name`` when the
    gradient reaches it, on the thread that runs the backward (the
    autograd engine's worker on the card). Each region closes the one
    before it; the last closes when the backward ends (an engine final
    callback). The profiler region opens only while a ``torch.profiler``
    session records: it would record nothing else, and entering and leaving
    one costs microseconds of host time. While a step record is open each
    region is also a span of it.

    The mark is a tensor hook that returns None: it changes no gradient and
    adds no node to the graph. With grad disabled, or on a tensor that
    needs none, it marks nothing. A region opens once a pass: a second
    marked output of one layer finds it open."""

    def __init__(self):
        self._seen = set()
        self._open = None  # (record_function, StepRecord or None, span index)

    def mark(self, t: torch.Tensor, name: str) -> None:
        if torch.is_grad_enabled() and t.requires_grad:
            t.register_hook(lambda grad: self._enter(name))

    def _enter(self, name: str) -> None:
        if name in self._seen:
            return
        if not self._seen:
            torch.autograd.Variable._execution_engine.queue_callback(self._close)
        self._seen.add(name)
        self._close()
        rf = None
        if torch.autograd.profiler._is_profiler_enabled:
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        rec = STEPS.open
        self._open = (rf, rec, None if rec is None else rec.open_span(name))

    def _close(self) -> None:
        if self._open is None:
            return
        rf, rec, i = self._open
        self._open = None
        if rec is not None:
            rec.close_span(i)
        if rf is not None:
            rf.__exit__(None, None, None)


def record_json(rec: StepRecord, t0_ns: int) -> Dict[str, object]:
    """A step record as JSON, times in microseconds after ``t0_ns`` (a
    trace's ``kineto_results.trace_start_ns()``: the clock of its events)
    and CPU in ms."""
    return {
        "start_us": (rec.start_ns - t0_ns) / 1e3, "end_us": (rec.end_ns - t0_ns) / 1e3,
        "profiled": rec.profiled, "host_cpu_ms": rec.host_cpu_ns / 1e6,
        "main_cpu_ms": rec.main_cpu_ns / 1e6, "worker_cpu_ms": rec.worker_cpu_ns / 1e6,
        "thread": rec.thread, "graph_layers": rec.graph_layers,
        "eager_layers": rec.eager_layers,
        "spans": [{"name": s.name, "parent": s.parent, "thread": s.thread,
                   "start_us": (s.start_ns - t0_ns) / 1e3, "end_us": (s.end_ns - t0_ns) / 1e3,
                   "cpu_ms": s.cpu_ns / 1e6} for s in rec.spans],
    }


def host_cpu_by_region(records: Sequence[StepRecord]) -> Dict[str, float]:
    """Host CPU ms of ``records``' spans by region name (a nested span
    counts in both, as ``device_breakdown``'s device time does)."""
    out: Dict[str, float] = defaultdict(float)
    for rec in records:
        for s in rec.spans:
            out[s.name] += s.cpu_ns / 1e6
    return dict(sorted(out.items()))


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
      ``busy_ms``       the union of the ops' intervals (no share of the
                        window: the profiler's own host work stretches it);
      ``launches``, ``dropped``  on the card, the kernel launch calls in
                        the window and those of them with no device record.

    On a CUDA ``device`` the ops are the device's kernels, copies and fills
    and their device time; a kernel counts in the regions its launch
    started in, on whichever host thread (the backward runs on the
    autograd engine's). A window with no device time raises: the card's
    trace is then missing, not idle. So does a window that lost a launched
    kernel's device record (``dropped`` > 0): its busy time would be short
    (trace with ``warmup``). On the CPU the ops
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
        "launches": launches,
        "dropped": dropped,
    }
