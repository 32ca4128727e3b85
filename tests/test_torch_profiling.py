"""The port's profiling hooks (tdeed_tpu_torch/utils/profiling.py) against
the JAX package's (tdeed_tpu/utils/profiling.py), on the CPU: the same
StepTimer summary on the same samples, a torch.profiler trace with a named
region, and time_fn's host-clock path."""

import json
import math

import pytest
import torch

from tdeed_tpu.utils import profiling as jax_profiling
from tdeed_tpu_torch.utils import profiling


def _comparable(summary):
    return {k: ("nan" if isinstance(v, float) and math.isnan(v) else v)
            for k, v in summary.items()}


@pytest.mark.parametrize(
    "samples,skip",
    [
        ([], 2),  # no samples: steps 0 and NaNs
        ([0.5, 0.4], 2),  # only warm-up samples: the same
        ([0.9, 0.8, 0.3], 2),
        ([0.9, 0.8, 0.3, 0.1, 0.2, 0.5, 0.4, 0.35, 0.25, 0.15, 0.45, 0.05, 0.3], 2),
        ([0.3, 0.1, 0.2], 0),
    ],
    ids=["empty", "warmup-only", "one", "thirteen", "no-warmup"],
)
def test_step_timer_summary_equals_the_jax_one(samples, skip):
    port, ref = profiling.StepTimer(), jax_profiling.StepTimer()
    port.samples, ref.samples = list(samples), list(samples)
    got, want = port.summary(skip), ref.summary(skip)
    assert list(got) == list(want)
    assert _comparable(got) == _comparable(want)


def test_step_timer_records_each_step():
    timer = profiling.StepTimer()
    for _ in range(3):
        with timer.step():
            pass
    assert len(timer.samples) == 3 and all(s >= 0 for s in timer.samples)
    assert timer.summary(skip_warmup=1)["steps"] == 2


def test_trace_writes_a_chrome_trace_with_the_named_region(tmp_path):
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path), "cpu") as prof:
        with profiling.annotate("probe_region"):
            x = x @ x
    assert "probe_region" in {e.key for e in prof.key_averages()}
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "probe_region" for e in events)


def test_time_fn_on_the_cpu_calls_warmup_plus_iters_times():
    calls = []
    sec = profiling.time_fn(lambda v: calls.append(v), 7, device="cpu", warmup=2, iters=5)
    assert calls == [7] * 7 and sec >= 0
