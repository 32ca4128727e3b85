"""The training step's backward segments on the card (models/tdeed.py,
utils/profiling.py ``BackwardSegments``): on the flagship step
(FineDiving_small: batch 8 x clip 100, 224 crops, bf16, K1) the three
segments, opened on the autograd engine's worker thread, hold at least
95% of the device time launched in ``backward``, and the last of them,
closed by the engine's final callback, ends after the backward's last
kernel launch and before ``.backward()`` returns; the step's record holds
the segments as spans of the worker thread, with its CPU. Needs a CUDA
GPU; skips without one. The card's machine has no JAX, and
tests/conftest.py imports it, so run this file there without the conftest:

    python -m pytest tests/test_torch_segments_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from tdeed_tpu_torch.tools import measure
from tdeed_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

SEGMENTS = ("backward.heads", "backward.temporal", "backward.trunk")
TRACED = 3


@pytest.fixture(scope="module")
def traced():
    """Three flagship steps traced after two warm and one thrown away:
    (the breakdown, the events, the steps' records, the trace's start)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from tdeed_tpu_torch.models.tdeed import build_model
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_train_step

    b, t, frame, crop, _ = measure.sizes("cuda")["flagship"]
    cfg = measure.flagship_config(t, crop, "cuda")
    r = np.random.default_rng(0)
    batches = [measure.on_device(measure.make_batch(
        r, b, t, frame, frame, cfg.num_classes_bg, cfg.radi_displacement, False), "cuda")
        for _ in range(2)]
    torch.manual_seed(0)
    model = build_model(cfg, device="cuda")
    opt, sched = make_optimizer(model.parameters(), 8e-4, 100, 10_000)
    step = make_train_step(model, opt, sched, crop_dim=crop, num_classes_bg=cfg.num_classes_bg,
                           mixup=True, radi_displacement=cfg.radi_displacement)
    for i in range(2):
        step(batches[i])
    torch.cuda.synchronize()
    with profiling.trace(None, "cuda", warmup=1) as prof:
        for i in range(1 + TRACED):
            step(batches[i % 2])
            torch.cuda.synchronize()
            prof.step()
    records = list(profiling.STEPS.records)[-TRACED:]
    events = [e for e in prof.events() if not e.is_async]
    yield (profiling.device_breakdown(prof, "cuda"), events, records,
           prof.profiler.kineto_results.trace_start_ns())
    torch.cuda.empty_cache()


def test_segments_hold_the_backwards_device_time(traced):
    out, _, _, _ = traced
    by = out["ms_by_region"]
    assert all(by[s] > 0 for s in SEGMENTS), by
    assert sum(by[s] for s in SEGMENTS) >= 0.95 * by["backward"], by
    assert by["backward.trunk"] > by["backward.temporal"] > by["backward.heads"], by


def test_trunk_segment_ends_after_the_backwards_last_launch(traced):
    _, events, records, t0 = traced
    # the host's regions (the trace also holds each as a device-side annotation)
    regions = [e for e in events if e.is_user_annotation and e.device_type == DeviceType.CPU]
    launches = [e for e in events if e.device_type == DeviceType.CPU
                and ("LaunchKernel" in e.name or e.name == "cudaMemcpyAsync")]
    backwards = [e for e in regions if e.name == "backward"]
    assert len(backwards) == TRACED
    for bw, rec in zip(sorted(backwards, key=lambda e: e.time_range.start), records):
        a, z = bw.time_range.start, bw.time_range.end
        (trunk,) = [e for e in regions if e.name == "backward.trunk"
                    and a <= e.time_range.start <= z]
        assert trunk.thread != bw.thread  # the worker's, not the step's thread
        last = max(e.time_range.start for e in launches if a <= e.time_range.start <= z)
        assert last <= trunk.time_range.end <= z
        # the record's span: closed on the worker thread, at the region's end
        span = next(s for s in rec.spans if s.name == "backward.trunk")
        assert rec.profiled and span.thread != rec.thread
        assert abs((span.end_ns - t0) / 1e3 - trunk.time_range.end) < 1e3
        # the worker's CPU, read in the card machine's 10 ms ticks
        assert rec.worker_cpu_ns >= span.cpu_ns >= 0 and rec.worker_cpu_ns > 0
