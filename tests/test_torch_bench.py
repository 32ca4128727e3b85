"""The port's measuring tools (tdeed_tpu_torch/tools/{bench,bench_snb,
bench_input,profile_step,profile_infer}.py), what they share
(tools/measure.py) and utils/profiling.py's breakdown, on the CPU:

- without a card and without ``--device cpu`` each device tool exits
  non-zero naming the missing card (bench_input, host work only, needs
  none);
- at tiny sizes with ``--device cpu`` each prints one JSON line, the dict
  its ``main`` returns, with the documented keys, finite numbers,
  "platform": "cpu" and no device memory;
- the synthetic batches of bench and bench_snb equal, bit for bit, those
  bench.py and tools/bench_snb.py draw from the same seed (their draws,
  nested in their ``main``, copied here);
- bench_input's pipeline yields the JAX tool's batches, frame for frame;
- ``device_breakdown`` of a traced tiny step finds every region of the
  step, with its busy time inside the window; on a card window (events
  made here) it links each kernel to its launch's region, and it refuses
  a card trace with no device time or with a launch whose kernel record
  is missing; the regions, the backward segments' hooks and the step
  record change no number of the step; profile_step writes the traced
  steps' records and their host CPU by region;
- the ``plain`` variant launches K1 zero times, the default once a
  micro-batch.
"""

import contextlib
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from tdeed_tpu_torch.config import TDEEDConfig
from tdeed_tpu_torch.kernels import augment as kaugment
from tdeed_tpu_torch.models.tdeed import build_model
from tdeed_tpu_torch.tools import (
    bench,
    bench_input,
    bench_snb,
    measure,
    profile_infer,
    profile_step,
)
from tdeed_tpu_torch.train import step as step_module
from tdeed_tpu_torch.train.schedule import make_optimizer
from tdeed_tpu_torch.train.step import make_predict_step, make_train_step
from tdeed_tpu_torch.utils import profiling

STEP_REGIONS = {"draw", "zero_grad", "crop", "mixup", "K1", "trunk", "temporal", "heads", "loss",
                "backward", "backward.heads", "backward.temporal", "backward.trunk",
                "optimizer"}
# regions that launch no work: no device (or, on the CPU, op) time
EMPTY_REGIONS = {"crop", "zero_grad"}

# tool -> (argv of a tiny CPU run, keys its JSON must hold)
TINY = {
    "bench": (bench, ["--snb_warmup", "0", "--snb_steps", "1"],
              {"metric", "value", "train_frames_per_sec", "train_step_ms",
               "train_peak_gib", "train_k1_launches_per_step", "predict_frames_per_sec_plain",
               "predict_frames_per_sec_hflip", "predict_peak_gib",
               "snb_challenge_train_frames_per_sec_acc2", "snb_peak_gib",
               "snb_k1_launches_per_step", "input_frames_per_sec",
               "input_frames_per_sec_cached", "input_cache_hit_rate"}),
    "bench_snb": (bench_snb, ["--variants", "k1,plain", "--warmup", "0", "--steps", "1",
                              "--height", "32", "--width", "64", "--batch", "2",
                              "--clip-len", "4"],
                  {"geometry", "acc_grad_iter", "k1", "plain", "predict"}),
    "profile_step": (profile_step, ["--iters", "1", "--trace", "TRACE_DIR"],
                     {"components", "trace"}),
    "profile_infer": (profile_infer, ["--iters", "1", "--snb", "--batches", "2", "--agg"],
                      {"predict", "snb", "agg"}),
}


@pytest.fixture(autouse=True)
def two_threads():
    """Two torch threads for each test (the suite's workers run one): at
    one thread torch's CPU kernel for the SGP-Mixer's depthwise conv1d
    loops over its 368 groups, and a trace of one tiny step holds ~430k
    events in place of ~39k, minutes of the profiler's own work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _flat(obj):
    """(key, value) of every leaf of nested dicts."""
    for k, v in obj.items():
        if isinstance(v, dict):
            yield from _flat(v)
        else:
            yield k, v


@pytest.mark.parametrize("name", sorted(TINY))
def test_device_tools_exit_without_a_card(monkeypatch, capsys, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        TINY[name][0].main([])
    assert isinstance(e.value.code, str)  # a message: exit status 1
    assert e.value.code.startswith(f"{name}: no CUDA device") and "--device cpu" in e.value.code
    assert capsys.readouterr().out == ""  # no result printed


@pytest.mark.parametrize("name", sorted(TINY))
def test_cpu_run_prints_one_json_line_with_finite_numbers(tmp_path, capsys, name):
    tool, argv, keys = TINY[name]
    argv = [str(tmp_path / "trace") if a == "TRACE_DIR" else a for a in argv]
    out = tool.main(argv + ["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(lines) == 1 and json.loads(lines[0]) == json.loads(json.dumps(out))
    assert out["tool"] == name and out["platform"] == "cpu" and out["card"] is None
    assert keys <= set(out)
    numbers = [v for _, v in _flat(out) if isinstance(v, (int, float)) and not isinstance(v, bool)]
    assert numbers and all(math.isfinite(v) for v in numbers)
    peaks = [v for k, v in _flat(out) if k.endswith("peak_gib")]
    assert all(v is None for v in peaks) and (bool(peaks) or name == "profile_step")
    if name == "bench":  # no assumed baseline rate
        assert "vs_baseline" not in out
    if name == "profile_step":  # the trace of 3 steps, reduced
        tr = out["trace"]
        assert (tmp_path / "trace" / "trace.json").exists()
        # on the CPU the plain chain runs, and its region says so
        regions = STEP_REGIONS - {"K1"} | {"augment_plain"}
        assert regions <= set(tr["ms_by_region"]) and "K1" not in tr["ms_by_region"]
        assert tr["steps"] == 3
        # no share of the traced window: the profiler's host work stretches it
        assert 0 < tr["busy_ms"] <= tr["wall_ms"] and not {"busy_share", "idle_share"} & set(tr)
        # the host CPU by region beside the device time, from the 3 steps' records
        assert regions <= set(tr["host_cpu_ms_by_region"])
        assert tr["host_cpu_ms_per_step"] >= tr["host_cpu_ms_by_region"]["backward"] / 3 > 0
        spans = json.loads((tmp_path / "trace" / "spans.json").read_text())
        assert spans["trace_start_ns"] > 0 and len(spans["steps"]) == 3
        for rec in spans["steps"]:
            assert rec["profiled"] and 0 <= rec["start_us"] < rec["end_us"]
            assert regions <= {sp["name"] for sp in rec["spans"]}
            assert all(rec["start_us"] <= sp["start_us"] <= sp["end_us"] <= rec["end_us"]
                       for sp in rec["spans"])
        # the plain chain on the CPU: no kernel, no launch
        assert tr["k1_kernel"] is None and tr["k1_launches"] == 0


def _bench_py_batch(r, b, t, f, num_classes_bg):
    """bench.py:107-116, as it draws."""
    return {
        "frame": r.integers(0, 256, (b, t, f, f, 3), np.uint8),
        "label": r.integers(0, num_classes_bg, (b, t)).astype(np.int32),
        "labelD": r.integers(-2, 3, (b, t)).astype(np.float32),
        "frame2": r.integers(0, 256, (b, t, f, f, 3), np.uint8),
        "label2": r.integers(0, num_classes_bg, (b, t)).astype(np.int32),
        "labelD2": r.integers(-2, 3, (b, t)).astype(np.float32),
    }


def _bench_snb_py_batch(r, b, t, h, w):
    """tools/bench_snb.py:137-152, as it draws (NUM_CLASSES 12, radius 4)."""
    return {
        "frame": r.integers(0, 256, (b, t, h, w, 3), np.uint8),
        "label": r.integers(0, 12 + 1, (b, t)).astype(np.int32),
        "labelD": r.integers(-4, 4 + 1, (b, t)).astype(np.float32),
        "frame2": r.integers(0, 256, (b, t, h, w, 3), np.uint8),
        "label2": r.integers(0, 12 + 1, (b, t)).astype(np.int32),
        "labelD2": r.integers(-4, 4 + 1, (b, t)).astype(np.float32),
        "dataset": np.ones((b,), np.int32),
    }


def _assert_batches_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_synthetic_batches_equal_the_jax_tools():
    cfg = measure.flagship_config(6, 8, "cpu")
    port, ref = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(measure.NUM_BATCHES):  # consecutive draws from one generator
        _assert_batches_equal(
            measure.make_batch(port, 2, 6, 12, 12, cfg.num_classes_bg, cfg.radi_displacement,
                                 False),
            _bench_py_batch(ref, 2, 6, 12, cfg.num_classes_bg))
    port, ref = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(2):
        _assert_batches_equal(
            measure.make_batch(port, 2, 4, 6, 10, measure.NUM_CLASSES + 1,
                               measure.RADI_DISPLACEMENT, True),
            _bench_snb_py_batch(ref, 2, 4, 6, 10))


@pytest.mark.parametrize("mixup,cache_mb", [(False, 0), (True, 0), (True, 64)],
                         ids=["cold", "mixup", "mixup-cached"])
def test_bench_pipeline_yields_the_jax_tools_batches(tmp_path, monkeypatch, mixup, cache_mb):
    """The same tiny tree through tools/bench_input.py and the port's copy:
    the same batches in the same order, frames bit for bit, and the frame
    count the port reports is that of its measured batches. No card is
    needed (host work)."""
    from tdeed_tpu.data import loader as jax_loader
    from tools import bench_input as jax_bench_input

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vdir = measure.synth_tree(str(tmp_path), 24, 48, 32)
    got = []
    run = measure.bench_pipeline(vdir, 24, 8, 2, 2, mixup, cache_mb=cache_mb, batches=got)
    want = []
    epoch = jax_loader.BatchLoader.epoch

    def tee(self, *args, **kwargs):
        for b in epoch(self, *args, **kwargs):
            want.append(b)
            yield b

    monkeypatch.setattr(jax_loader.BatchLoader, "epoch", tee)
    fps = jax_bench_input.bench_pipeline(vdir, 24, 8, 2, 2, mixup, cache_mb=cache_mb)
    n_warm = 1 if cache_mb == 0 else 2
    assert fps > 0 and run["fps"] > 0 and len(got) == len(want) == 2 + 1 + n_warm
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    assert run["frames"] == sum(b["frame"].shape[0] * 8 for b in want[n_warm:n_warm + 2])
    assert ("hit_rate" in run) == bool(cache_mb)


def test_synth_tree_writes_the_jax_tools_frames(tmp_path):
    from tools import bench_input as jax_bench_input

    a = measure.synth_tree(str(tmp_path / "port"), 3, 20, 12)
    b = jax_bench_input.synth_tree(str(tmp_path / "jax"), 3, 20, 12)
    for i in range(1, 4):
        with open(f"{a}/{i:04d}.jpg", "rb") as fa, open(f"{b}/{i:04d}.jpg", "rb") as fb:
            assert fa.read() == fb.read()


def test_bench_input_leaves_the_feed_rows_out_without_a_target(monkeypatch, capsys):
    """No TPU rate stands as a default: without --target no cores_to_feed
    row; with it, the rows computed from the measured rates."""
    calls = []

    def fake_pipeline(vdir, n_frames, clip_len, batch, n_batches, mixup, cache_mb=0):
        calls.append((mixup, cache_mb))
        return {"frames": 800, "seconds": 1.0, "fps": 800.0 * (1 + len(calls)),
                **({"hit_rate": 1.0} if cache_mb else {})}

    monkeypatch.setattr(bench_input, "synth_tree", lambda root, n, w, h: root)
    monkeypatch.setattr(bench_input, "bench_decoders", lambda vdir, n, w, h: {})
    monkeypatch.setattr(bench_input, "bench_pipeline", fake_pipeline)
    out = bench_input.main([])
    assert not any(k.startswith(("cores_to_feed", "target")) for k in out)
    out = bench_input.main(["--target", "4000"])
    cores = out["cores"]
    assert out["cores_to_feed_target"] == 2 * 4000 / (out["pipeline_fps"] / cores)
    assert out["cores_to_feed_target_cached"] == 4000 / (out["pipeline_fps_mixup_cached"] / cores)


def _tiny_trainer(pallas_augment=None, acc=1):
    cfg = TDEEDConfig(dataset="finediving", num_classes=4, clip_len=8, crop_dim=32,
                      feature_arch="rny002_gsf", n_layers=1, sgp_ks=3, sgp_r=2,
                      radi_displacement=2, dtype="float32")
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    opt, sched = make_optimizer(model.parameters(), 1e-3, 1, 10)
    step = make_train_step(model, opt, sched, crop_dim=32, num_classes_bg=5, mixup=True,
                           radi_displacement=2, acc_grad_iter=acc, pallas_augment=pallas_augment)
    batch = measure.on_device(measure.make_batch(np.random.default_rng(0), 2, 8, 36, 36, 5, 2,
                                                 False), "cpu")
    return model, step, batch


def test_device_breakdown_finds_every_region_of_a_step():
    """A traced plain-route step and a predict call: every region, with
    time in each but the crop's (a view) and zero_grad's (set to None), the
    top ops, the busy time inside the window. (The K1 route's regions: the
    profile_step case above.)"""
    model, step, batch = _tiny_trainer(pallas_augment=False)
    predict = make_predict_step(model, crop_dim=32, radi_displacement=2)
    step(batch)
    with profiling.trace(None, "cpu") as prof:
        step(batch)
        predict(batch["frame"])
    out = profiling.device_breakdown(prof, "cpu", top=5)
    assert out["platform"] == "cpu"
    regions = STEP_REGIONS - {"K1"} | {"augment_plain", "forward"}
    assert regions <= set(out["ms_by_region"]) and "K1" not in out["ms_by_region"]
    assert all(out["ms_by_region"][r] > 0 for r in regions - EMPTY_REGIONS)
    assert len(out["ms_by_op"]) == 5 and all(v["ms"] > 0 for v in out["ms_by_op"].values())
    assert 0 < out["busy_ms"] <= out["wall_ms"]
    assert not {"busy_share", "idle_share"} & set(out)


def test_device_breakdown_refuses_a_card_trace_without_device_time():
    with profiling.trace(None, "cpu") as prof:
        torch.ones(8) * 2
    with pytest.raises(RuntimeError, match="no device time"):
        profiling.device_breakdown(prof, "cuda")


def _event(name, id_, start, end, device_type, user=False):
    """The fields device_breakdown reads of a profiler FunctionEvent."""
    return SimpleNamespace(name=name, id=id_, is_async=False, device_type=device_type,
                           is_user_annotation=user, self_cpu_time_total=end - start,
                           time_range=SimpleNamespace(start=start, end=end,
                                                      elapsed_us=lambda: end - start))


def _card_window(lose_mul=False):
    """A card window: K1 launched through cudaLaunchKernelExC inside the
    K1 region, a ``mul`` through cudaLaunchKernel outside every region
    (its device record left out with ``lose_mul``), a host-only API call."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_event("K1", 1, 0, 10, cpu, user=True),
              _event("cudaLaunchKernelExC", 7, 1, 2, cpu),
              _event("photometric_kernel", 7, 3, 8, cuda),
              _event("cudaGetErrorString", 9, 11, 12, cpu),
              _event("cudaLaunchKernel", 8, 12, 13, cpu)]
    if not lose_mul:
        events.append(_event("mul", 8, 14, 20, cuda))
    return SimpleNamespace(events=lambda: events)


def test_device_breakdown_links_each_kernel_to_its_launch():
    """On the card each kernel counts in the region its launch call sat in
    (matched by correlation id), and every launch has its record."""
    out = profiling.device_breakdown(_card_window(), "cuda")
    assert out["platform"] == "gpu" and (out["launches"], out["dropped"]) == (2, 0)
    assert out["ms_by_region"] == pytest.approx({"K1": 0.005, "unannotated": 0.006})
    assert out["ms_by_op"]["photometric_kernel"] == {"ms": pytest.approx(0.005), "calls": 1}
    assert (out["busy_ms"], out["wall_ms"]) == pytest.approx((0.011, 0.020))


def test_device_breakdown_refuses_a_window_that_lost_a_kernel_record():
    """A launch call whose kernel the trace does not hold: the busy time
    would be short, so the breakdown raises and names the count."""
    with pytest.raises(RuntimeError, match="1 of the window's 2 kernel launches"):
        profiling.device_breakdown(_card_window(lose_mul=True), "cuda")


@pytest.mark.parametrize("off", ["annotate", "segments_and_record"])
def test_regions_change_no_number_of_the_step(monkeypatch, off):
    """The same step with every annotate a no-op, or with the backward
    segments' hooks and the step record no-ops, gives the same loss and
    weights, bit for bit."""
    model, step, batch = _tiny_trainer()
    loss = step(batch)["loss"]
    if off == "annotate":
        monkeypatch.setattr(step_module, "annotate", lambda name: contextlib.nullcontext())
        monkeypatch.setattr("tdeed_tpu_torch.models.tdeed.annotate",
                            lambda name: contextlib.nullcontext())
    else:
        monkeypatch.setattr(profiling.BackwardSegments, "mark", lambda self, t, name: None)
        monkeypatch.setattr(profiling.STEPS, "record", contextlib.nullcontext)
    last = profiling.STEPS.records[-1]
    model2, step2, _ = _tiny_trainer()
    assert torch.equal(step2(batch)["loss"], loss)
    for a, b in zip(model.state_dict().values(), model2.state_dict().values()):
        assert torch.equal(a, b)
    assert (profiling.STEPS.records[-1] is last) == (off != "annotate")


@pytest.mark.parametrize("variant,acc", [("k1", 2), ("plain", 2), ("plain", 1)])
def test_k1_launches_of_the_variants(monkeypatch, variant, acc):
    """A counting K1 in place of the kernel (on the CPU ``photometric``
    runs the plain chain and counts nothing): the default launches it once
    a micro-batch, ``plain`` never."""
    def counting(frames, params):
        counting.launches += 1
        return kaugment.photometric_reference(frames, params)

    counting.launches = 0
    monkeypatch.setattr(kaugment, "photometric", counting)
    overrides, pallas_augment = bench_snb.VARIANTS[variant]
    cfg = measure.snb_config(4, "cpu", **overrides)
    torch.manual_seed(0)
    init = build_model(cfg, measure.TWO_HEADS, device="cpu").state_dict()
    batches = [measure.on_device(measure.make_batch(
        np.random.default_rng(0), 2, 4, 16, 24, 13, 4, True), "cpu")]
    out = measure.train_steps(cfg, init, batches, acc=acc, warmup=0, steps=1, device="cpu",
                              pallas_augment=pallas_augment)
    assert out["k1_launches_per_step"] == counting.launches == (acc if variant == "k1" else 0)


def test_step_timer_ms_and_time_calls():
    timer = profiling.StepTimer("cpu")
    with pytest.raises(ValueError):
        timer.ms()
    timer.samples = [0.003, 0.001, 0.002, 0.010]
    got = timer.ms()
    assert got["n"] == 4 and got["median"] == pytest.approx(2.5)
    assert (got["min"], got["max"]) == pytest.approx((1.0, 10.0))
    seen = []
    ms = measure.time_calls(seen.append, ["a", "b"], warmup=1, calls=3, device="cpu")
    assert seen == ["a", "b", "a", "b"] and ms["n"] == 3 and ms["min"] >= 0


def test_predict_calls_interleave_the_passes(monkeypatch):
    """Plain and hflip calls alternate from the first warm-up round on, each
    pass timed ``calls`` times over the cycled batches."""
    seen = []

    def fake_predict_step(model, *, crop_dim, radi_displacement):
        return lambda frames, hflip: seen.append((int(frames[0, 0, 0, 0, 0]), hflip))

    monkeypatch.setattr(step_module, "make_predict_step", fake_predict_step)
    frames = [torch.full((2, 3, 4, 4, 3), i, dtype=torch.uint8) for i in range(2)]
    out = measure.predict_calls(None, None, 0, frames, calls=3, device="cpu",
                                hflips=(False, True))
    rounds = measure.PREDICT_WARMUP + 3
    assert seen == [(i % 2, h) for i in range(rounds) for h in (False, True)]
    assert set(out) == {False, True} and all(v["call_ms"]["n"] == 3 for v in out.values())
    assert all(v["frames_per_sec"] > 0 for v in out.values())


def test_card_reads_nvidia_smi(monkeypatch):
    class Done:
        stdout = "NVIDIA H100 80GB HBM3, 700.00 W\n"

    monkeypatch.setattr(profiling.subprocess, "run", lambda *a, **k: Done())
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert profiling.card() == {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
                                "count": 1, "smi": "NVIDIA H100 80GB HBM3, 700.00 W"}
