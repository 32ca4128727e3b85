"""The training step's backward segments and host record
(tdeed_tpu_torch/utils/profiling.py ``BackwardSegments``, ``STEPS``;
models/tdeed.py; train/step.py) and the benchmark's readers of them
(benchmark/metrics/), on the CPU at a tiny size:

- every backward op whose forward op ran in ``trunk``, ``temporal`` or
  ``heads`` runs inside ``backward.trunk``, ``backward.temporal`` or
  ``backward.heads``, and each of the three holds time;
- with ``acc_grad_iter`` 2 one step's record holds two sets of segments;
- the ring keeps the last 256 steps, marks those a profiler recorded,
  links each span to its parent, and its spans start where the profiler's
  regions start;
- spans on another thread (the autograd engine's worker on the card)
  count as worker CPU, and a segment closes on the thread that ran the
  backward;
- the predict step and a no-grad forward register no hook;
- the four per-layer readers, on synthetic readings and rings.

The card's side (the three segments hold the backward's device time, the
trunk segment closes on the worker thread after its last launch) is in
tests/test_torch_segments_gpu.py.
"""

import threading

import pytest
import torch

from benchmark.run import load_reader
from tdeed_tpu_torch.train.step import make_predict_step
from tdeed_tpu_torch.utils import profiling
from test_torch_bench import _tiny_trainer, two_threads  # noqa: F401 (an autouse fixture)

LAYERS = ("trunk", "temporal", "heads")
SEGMENTS = ("backward.heads", "backward.temporal", "backward.trunk")  # in the order they run


@pytest.fixture
def ring(monkeypatch):
    """A fresh ring in place of the process's."""
    fresh = profiling.StepRecorder()
    monkeypatch.setattr(profiling, "STEPS", fresh)
    return fresh


@pytest.fixture(scope="module")
def traced():
    """One warm plain-route step, then one traced: (events, the traced
    step's record, the trace's start in Unix ns)."""
    model, step, batch = _tiny_trainer(pallas_augment=False)
    step(batch)
    with profiling.trace(None, "cpu") as prof:
        step(batch)
    events = [e for e in prof.events() if not e.is_async]
    return events, profiling.STEPS.records[-1], prof.profiler.kineto_results.trace_start_ns()


def _regions(events):
    return {e.name: e for e in events if e.is_user_annotation}


def _inside(t, region):
    return region.time_range.start <= t <= region.time_range.end


def test_backward_ops_run_in_their_layers_segment(traced):
    events, _, _ = traced
    regions = _regions(events)
    backward = regions["backward"]
    # the layer each forward op ran in, by its autograd sequence number; an
    # op that makes no node reads the next op's number, so the last wins
    forward = {}
    for e in events:
        if (e.is_user_annotation or e.sequence_nr < 0
                or e.time_range.start >= backward.time_range.start):
            continue
        if e.sequence_nr not in forward or forward[e.sequence_nr][0] < e.time_range.start:
            layer = next((ly for ly in LAYERS if _inside(e.time_range.start, regions[ly])), None)
            forward[e.sequence_nr] = (e.time_range.start, layer)
    seen = dict.fromkeys(LAYERS, 0)
    for e in events:
        if not e.name.startswith("autograd::engine::evaluate_function"):
            continue
        layer = forward.get(e.sequence_nr, (0, None))[1]
        if layer is None:
            continue
        seg = regions[f"backward.{layer}"]
        # the node's work (its ops) inside the segment; the node that opens
        # a segment starts, through its hook, just before it
        assert all(_inside(c.time_range.start, seg) for c in e.cpu_children), (e.name, layer)
        assert _inside(e.time_range.end, seg), (e.name, layer)
        seen[layer] += 1
    assert all(n > 0 for n in seen.values()), seen


def test_each_segment_holds_time_inside_backward(traced):
    events, _, _ = traced
    regions = _regions(events)
    backward = regions["backward"]
    for name in SEGMENTS:
        seg = regions[name]
        assert seg.time_range.elapsed_us() > 0
        assert backward.time_range.start <= seg.time_range.start
        assert seg.time_range.end <= backward.time_range.end
    # in turn: heads, temporal, trunk, each closed before the next opens
    for a, b in zip(SEGMENTS, SEGMENTS[1:]):
        assert regions[a].time_range.end <= regions[b].time_range.start


def test_record_spans_start_with_their_profiler_regions(traced):
    events, rec, t0 = traced
    regions = _regions(events)
    assert rec.profiled
    for s in rec.spans:
        r = regions[s.name]
        assert abs((s.start_ns - t0) / 1e3 - r.time_range.start) < 1e3, s.name  # 1 ms
        assert abs((s.end_ns - t0) / 1e3 - r.time_range.end) < 1e3, s.name


def test_record_links_each_span_to_its_parent(traced):
    _, rec, _ = traced
    names = [s.name for s in rec.spans]
    by_name = dict(zip(names, rec.spans))
    assert {"draw", "zero_grad", "trunk", "temporal", "heads", "loss", "backward",
            "optimizer", *SEGMENTS} <= set(names)
    backward = names.index("backward")
    for name in SEGMENTS:
        assert by_name[name].parent == backward
    assert all(by_name[n].parent is None for n in ("draw", "trunk", "backward", "optimizer"))
    for s in rec.spans:
        assert s.start_ns <= s.end_ns and s.cpu_ns >= 0
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # on the CPU the backward runs on the step's thread: no worker CPU
    assert rec.worker_cpu_ns == 0 and rec.host_cpu_ns == rec.main_cpu_ns > 0
    assert rec.main_cpu_ns >= by_name["backward"].cpu_ns


def test_two_micro_batches_record_two_sets_of_segments(ring):
    model, step, batch = _tiny_trainer(pallas_augment=False, acc=2)
    step(batch)
    (rec,) = ring.records
    names = [s.name for s in rec.spans]
    backwards = [i for i, n in enumerate(names) if n == "backward"]
    assert len(backwards) == 2 and names.count("trunk") == 2
    for i in backwards:
        assert [s.name for s in rec.spans if s.parent == i] == list(SEGMENTS)


def test_ring_keeps_the_last_256_steps(ring):
    for i in range(profiling.RING_STEPS + 4):
        with ring.record():
            with profiling.annotate(f"s{i}"):
                pass
    assert len(ring.records) == profiling.RING_STEPS == 256
    assert [r.spans[0].name for r in ring.records][:2] == ["s4", "s5"]
    assert ring.open is None


def test_ring_marks_the_steps_a_profiler_recorded(ring):
    model, step, batch = _tiny_trainer(pallas_augment=False)
    step(batch)
    with profiling.trace(None, "cpu", warmup=1) as prof:
        for _ in range(2):
            step(batch)
            prof.step()
    step(batch)
    # the scheduled session's warm-up step records no region: not profiled
    assert [r.profiled for r in ring.records] == [False, False, True, False]


def test_a_step_that_raises_leaves_no_record(ring):
    with pytest.raises(ValueError):
        with ring.record():
            raise ValueError("a failing step")
    assert not ring.records and ring.open is None


def test_outside_a_step_annotate_is_the_profiler_region(ring):
    assert isinstance(profiling.annotate("x"), torch.profiler.record_function)
    with ring.record():
        assert not isinstance(profiling.annotate("x"), torch.profiler.record_function)


def test_spans_of_another_thread_count_as_worker_cpu(ring):
    """A span opened on another thread (on the card, the autograd
    engine's worker) takes the step thread's innermost open span as its
    parent and adds its CPU to the record's worker CPU, as a backward run
    on another thread does with its segments, the last closed on that
    thread by the engine's final callback."""
    model, step, batch = _tiny_trainer(pallas_augment=False)
    seen = {}

    def spin():
        with profiling.annotate("worker"):
            x = torch.ones(256, 256)
            for _ in range(20):
                x = x @ x / 256
        seen["thread"] = threading.get_ident()

    with ring.record() as rec:
        with profiling.annotate("outer"):
            t = threading.Thread(target=spin)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    outer, worker = rec.spans
    assert worker.parent == 0 and worker.thread == seen["thread"] != rec.thread
    assert rec.worker_cpu_ns == worker.cpu_ns > 0
    assert rec.host_cpu_ns == rec.main_cpu_ns + worker.cpu_ns

    # a backward run on another thread: its segments open and close there
    model.train()
    x = torch.rand(2, 8, 32, 32, 3)
    with ring.record() as rec:
        loss = model(x)["logits"].sum()
        t = threading.Thread(target=loss.backward)
        t.start()
        t.join(timeout=60)
    assert not t.is_alive()
    segs = [s for s in rec.spans if s.name in SEGMENTS]
    assert [s.name for s in segs] == list(SEGMENTS)
    assert all(s.thread != rec.thread and s.end_ns >= s.start_ns for s in segs)
    assert rec.worker_cpu_ns == sum(s.cpu_ns for s in segs) > 0


def _hook_counter(monkeypatch):
    calls = []
    register = torch.Tensor.register_hook

    def counting(self, hook):
        calls.append(self.shape)
        return register(self, hook)

    monkeypatch.setattr(torch.Tensor, "register_hook", counting)
    return calls


def test_predict_and_no_grad_forwards_register_no_hook(monkeypatch):
    model, _, batch = _tiny_trainer()
    calls = _hook_counter(monkeypatch)
    predict = make_predict_step(model, crop_dim=32, radi_displacement=2)
    predict(batch["frame"])
    predict(batch["frame"], hflip=True)
    x = torch.rand(2, 8, 32, 32, 3)
    with torch.no_grad():
        model.train()(x)
    assert calls == []
    model(x)  # grad on: the trunk's and temporal layer's outputs and both heads'
    assert len(calls) == 4


# --- the benchmark's readers ------------------------------------------------


@pytest.mark.parametrize("layer", LAYERS)
def test_backward_segment_readers(layer):
    read = load_reader(f"models.{layer}_bwd_ms")
    r = {"trace": {"ms_by_region": {"backward": 120.0, f"backward.{layer}": 90.0}},
         "units_traced": 3}
    assert read(r) == pytest.approx(30.0)
    # the parent commit's trace: no segment, no reading
    assert read({"trace": {"ms_by_region": {"backward": 120.0}}, "units_traced": 3}) is None


def _record(host_ms, profiled):
    rec = profiling.StepRecord(0, 0, profiled)
    rec.main_cpu_ns, rec.worker_cpu_ns = int(host_ms * 0.6e6), int(host_ms * 0.4e6)
    return rec


def test_host_cpu_reader_takes_the_interquartile_mean_of_unprofiled_steps(ring):
    read = load_reader("train_step.host_cpu_ms")
    assert read({}) is None  # an empty ring
    # a cold set-up step and steps read in 10 ms ticks; the profiled ones left out
    ring.records.extend([_record(ms, False) for ms in (2400, 190, 200, 200, 190, 210, 200,
                                                       180)])
    ring.records.extend([_record(900, True) for _ in range(5)])
    # quartiles 190 and 207.5: the mean of 190, 200, 200, 190, 200
    assert read({}) == pytest.approx(196.0)
    ring.records.clear()
    ring.records.extend([_record(900, True), _record(150, False)])
    assert read({}) == pytest.approx(150.0)  # one unprofiled step
    ring.records.popleft()
    ring.records.pop()
    ring.records.append(_record(900, True))
    assert read({}) is None  # only profiled steps


def test_host_cpu_reader_reads_nothing_without_a_ring(monkeypatch):
    monkeypatch.delattr(profiling, "STEPS")  # the parent commit's program
    assert load_reader("train_step.host_cpu_ms")({}) is None


def test_host_cpu_reader_on_a_ring_of_real_steps(ring):
    model, step, batch = _tiny_trainer(pallas_augment=False)
    for _ in range(3):
        step(batch)
    with profiling.trace(None, "cpu") as prof:
        step(batch)
    assert [r.profiled for r in ring.records] == [False, False, False, True]
    # of three values the quartiles are the least and the largest: all count
    want = sum(r.host_cpu_ns for r in list(ring.records)[:3]) / 3 / 1e6
    assert load_reader("train_step.host_cpu_ms")({}) == pytest.approx(want)
    assert prof is not None
