#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tdeed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: a CUDA card is required (no CPU path); prints the card's name
     and power limit and the TF32 switches;
  2. build: compiles the photometric kernel (csrc/photometric.cu) and the
     probe kernels (csrc/probe.cu) with nvcc, one process each, together;
  3. kernel: the photometric kernel against its plain PyTorch version on
     the card, all 64 gate combinations (hue, saturation, brightness,
     contrast, blur, flip), uint8 and bf16 input, 224x224, 448x796 and
     16x2200 (bf16 there in 2 column segments); then at the flagship shape
     (8, 100, 224, 224, 3) bf16 against the plain version and against its
     own second call (the same bits), and both timed there; the kernel also
     with every gate on in every clip, and at SoccerNet Ball's full frames
     (8, 100, 448, 796, 3) bf16;
  3b. probe: the probe tool (tdeed_tpu_torch.tools.profile_probe) on the
     card at its full shape (112, 112, 24, 800), which must launch each of
     the three probe kernels; then each kernel against its plain version at
     the tool's shapes (perpix also at (112, 56, 48, 800)), the plain
     versions timed, and the perpix and outerp launch plans logged;
  4. agreement: on a small input, one fp32 train step and one predict
     call on the card against the same calls on the CPU, same weights and
     random draws (the CPU path is the one held against the JAX package by
     the tier-1 tests);
  5. serve: FineDiving_small at full width with seeded random weights
     answers 4-clip requests (100 frames of 256x256 uint8 each), plain and
     with the hflip TTA;
  5b. spot: a SpottingPredictor with the same weights spots events in one
     synthetic 600-frame video with the hflip TTA (batch 1, 2 passes) and
     without (batch 4): device and host aggregation give the same bits,
     two calls give the same bits, every event is a known class at a frame
     of the video with a score in [0, 1]; then evaluate() over a 2-video
     split gives a finite mAP in [0, 1]. It must not launch the
     photometric kernel (a training augmentation);
  6. train: 3 steps of the flagship training step (batch 8 x clip 100,
     256x256 uint8 cropped to 224, mixup on, bf16 compute, AdamW), which
     must go through the CUDA kernel.

The line before the last is a JSON object with each kernel's route, the
TPU kernel it replaces, its launches on its path (phases 5-6 for the
photometric kernel, the probe tool's run for the probe kernels), its
largest error against the plain version, its time, the plain version's,
the one PyTorch call's that computes the same function (null where there
is none) and the card's bound for the same work; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, it exits non-zero and prints neither.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SEED = 0
REPO = Path(__file__).resolve().parent
CONFIGS = str(REPO / "configs")
BF16_ULP_AT_2 = 2.0 ** -6  # standardized outputs lie in about [-2.12, 2.64]
COMPARE_SHAPES = ((224, 224), (448, 796), (16, 2200))
FLAGSHIP = (8, 100, 224, 224, 3)
SNB_FULL = (8, 100, 448, 796, 3)  # SoccerNet Ball's full frames, crop_dim -1
FRAME = 256  # request and training frames before the 224 crop
REQUESTS = 3
REQUEST_CLIPS = 4
TRAIN_STEPS = 3
SPOT_FRAMES = 600  # the video spot() runs over; evaluate() adds one of EVAL_FRAMES
EVAL_FRAMES = 300
KERNEL_SOURCES = ("photometric", "probe")
# fp32 operations per pixel of the photometric chain (each add, sub, mul,
# div, min, max and floor once; the blur as two separable 5-tap passes), for
# the gates that are on; a gate that is off needs none: /255 and the
# standardization 9; hue 32; saturation 21; brightness 9; contrast 16, and
# 6 more for the frame's gray mean; blur 2 x 27
K1_OPS_ALWAYS = 9
K1_OPS_GATED = ((0, 32), (2, 21), (4, 9), (6, 22), (8, 54))  # (param slot, ops)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def device_phase(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device count {torch.cuda.device_count()}")
    log(f"[device] allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    log(smi)
    return smi


def build_phase():
    from tdeed_tpu_torch.kernels.build import load

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        builds = list(pool.map(load, KERNEL_SOURCES))  # raises if nvcc fails
    for built in builds:
        how = f"nvcc {built.seconds:.1f} s" if built.log else "reused from an earlier build"
        log(f"[build] {built.path.name}: {how}")
        for line in built.log.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"[build] ptxas: {line.strip()}")
    log(f"[build] {len(builds)} libraries, {time.perf_counter() - t0:.1f} s in all")


def _gate_params(torch, generator, device):
    """(64, 16) params: clip c turns on the gates named by the bits of c."""
    from tdeed_tpu_torch.kernels.augment import sample_params

    p = sample_params(generator, 64)
    combos = torch.arange(64)
    for bit, slot in enumerate((0, 2, 4, 6, 8, 14)):  # hue sat bri con blur flip
        p[:, slot] = ((combos >> bit) & 1).float()
    return p.to(device)


def _check_close(torch, got, want, what, max_abs=None):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    # 1 bf16 ulp at the value's magnitude, floored at 2^-16: near 0 the
    # standardization (c - mean) / std cancels, and the fp32 rounding of c
    # (the plain version on the card divides by a scalar as a multiply by
    # its reciprocal) leaves ~1e-6 absolute there
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -9)
    bound = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    n_bad = int((err > bound).sum())
    max_err, mean_err = float(err.max()), float(err.mean())
    log(f"[kernel] {what}: max abs err {max_err:.6g}, mean {mean_err:.3g}, "
        f"beyond 1 bf16 ulp: {n_bad} of {err.numel()}")
    if n_bad or (max_abs is not None and max_err > max_abs):
        fail(f"a kernel disagrees with its plain version ({what})")
    return max_err


def _check_equal(torch, got, want, what):
    same = torch.equal(got, want)
    log(f"[probe] {what}: bit-exact {same}")
    if not same:
        fail(f"a kernel disagrees with its plain version ({what})")


def _time_ms(torch, fn, iters):
    """CUDA-event time of one call, after one warm-up call."""
    from tdeed_tpu_torch.utils.profiling import time_fn

    return time_fn(fn, device="cuda", warmup=1, iters=iters) * 1e3


def kernel_phase(torch):
    from tdeed_tpu_torch.kernels.augment import (
        photometric,
        photometric_plan,
        photometric_reference,
        sample_params,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = _gate_params(torch, torch.Generator().manual_seed(SEED), dev)
    max_err = 0.0
    for h, w in COMPARE_SHAPES:
        shape = (64, 2, h, w, 3)
        u8 = torch.randint(0, 256, shape, generator=gen, device=dev, dtype=torch.uint8)
        blend = (torch.rand(shape, generator=gen, device=dev) * 255).to(torch.bfloat16)
        for name, frames in (("uint8", u8), ("bf16", blend)):
            got = photometric(frames, params)
            torch.cuda.synchronize()
            want = photometric_reference(frames, params)
            max_err = max(max_err, _check_close(
                torch, got, want, f"{name} {h}x{w}, 64 gate combinations x 2 frames",
                BF16_ULP_AT_2))
            del got, want
        del u8, blend

    frames = (torch.rand(FLAGSHIP, generator=gen, device=dev) * 255).to(torch.bfloat16)
    p8 = sample_params(torch.Generator().manual_seed(SEED + 1), FLAGSHIP[0]).to(dev)
    got = photometric(frames, p8)
    torch.cuda.synchronize()
    max_err = max(max_err, _check_close(
        torch, got, photometric_reference(frames, p8), f"bf16 {FLAGSHIP}, sampled params",
        BF16_ULP_AT_2))
    same = torch.equal(got, photometric(frames, p8))
    log(f"[kernel] flagship: two calls give the same bits: {same}")
    if not same:
        fail("two calls of the photometric kernel differ")
    del got
    every = p8.clone()
    every[:, [0, 2, 4, 6, 8, 14]] = 1.0  # hue sat bri con blur flip
    ms = _time_ms(torch, lambda: photometric(frames, p8), 20)
    plain_ms = _time_ms(torch, lambda: photometric_reference(frames, p8), 3)
    ms_all = _time_ms(torch, lambda: photometric(frames, every), 20)
    ms2 = _time_ms(torch, lambda: photometric(frames, p8), 20)
    moved = 2 * frames.numel() * 2  # bf16 in + bf16 out
    bound_ms, bound_by = _k1_bound(p8, moved, FLAGSHIP)
    bound_all, bound_all_by = _k1_bound(every, moved, FLAGSHIP)
    plan = _k1_plan(photometric_plan(*FLAGSHIP[2:4], frames.dtype))
    log(f"[kernel] flagship {FLAGSHIP} bf16, plan {plan}: kernel {ms:.3f} ms then "
        f"{ms2:.3f} ms ({moved / (min(ms, ms2) * 1e-3) / 1e9:.0f} GB/s of the 482 MB "
        f"moved), plain PyTorch {plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by})")
    log(f"[kernel] flagship, every gate on in every clip: ms_all_gates {ms_all:.3f}, "
        f"bound {bound_all:.4f} ms ({bound_all_by}), {bound_all / ms_all:.0%} of it")
    del frames
    frames = (torch.rand(SNB_FULL, generator=gen, device=dev) * 255).to(torch.bfloat16)
    snb_ms = _time_ms(torch, lambda: photometric(frames, p8), 20)
    snb_moved = 2 * frames.numel() * 2
    snb_bound, snb_bound_by = _k1_bound(p8, snb_moved, SNB_FULL)
    snb_plan = _k1_plan(photometric_plan(*SNB_FULL[2:4], frames.dtype))
    log(f"[kernel] SoccerNet Ball full frames {SNB_FULL} bf16, sampled params, plan "
        f"{snb_plan}: kernel {snb_ms:.3f} ms ({snb_moved / (snb_ms * 1e-3) / 1e9:.0f} GB/s), "
        f"bound {snb_bound:.4f} ms ({snb_bound_by}), {snb_bound / snb_ms:.0%} of it")
    del frames
    return {
        "name": "photometric",
        "route": "cuda",
        "source": "tdeed_tpu_torch/csrc/photometric.cu",
        "replaces": "tdeed_tpu/kernels/augment.py:301",
        "max_abs_err": max_err,
        "ms": min(ms, ms2),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,  # no one PyTorch call computes the chain
        "plan": plan,
        "ms_all_gates": ms_all,
        "bound_all_gates_ms": bound_all,
        "snb_shape": list(SNB_FULL),
        "snb_ms": snb_ms,
        "snb_bound_ms": snb_bound,
        "snb_plan": snb_plan,
    }


def _k1_plan(plan):
    return {k: getattr(plan, k) for k in (
        "bands", "rows", "segments", "seg_w", "chunk", "smem_bytes")}


def _k1_bound(params, moved, shape):
    """The card's least time for a call on `shape`: its bytes, or the fp32
    operations of the gates these params turn on, at the CUDA cores' peak."""
    from tdeed_tpu_torch.utils.profiling import PEAK_FP32_FLOPS, bound

    on = (params.cpu() > 0.5).float()
    per_clip = K1_OPS_ALWAYS + sum(ops * on[:, slot] for slot, ops in K1_OPS_GATED)
    ops = float(per_clip.sum()) * math.prod(shape[1:4])
    return bound(moved, ops, PEAK_FP32_FLOPS)


def probe_phase(torch):
    """The probe tool's run on the card (its kernels' path), then each probe
    kernel against its plain version at the tool's shapes."""
    from tdeed_tpu_torch.kernels import probe
    from tdeed_tpu_torch.tools import profile_probe

    kernels = {"stream": probe.stream, "perpix": probe.perpix, "outerp": probe.outerp}
    for fn in kernels.values():
        fn.launches = 0
    results = {r.name: r for r in profile_probe.main([])}
    launches = {name: fn.launches for name, fn in kernels.items()}
    log(f"[probe] the tool's run launched {launches}")
    if min(launches.values()) < 1:
        fail(f"the probe tool did not launch every probe kernel: {launches}")

    h, w, c, n = profile_probe.SHAPE
    x, w1, w2 = profile_probe.make_inputs(profile_probe.SHAPE, "cuda")
    stacked = x.view(h, w // 2, 2 * c, n)
    entries = {}

    def entry(name, line, err, result, plain_ms, library=True):
        return {
            "name": f"probe_{name}",
            "route": "cuda",
            "source": "tdeed_tpu_torch/csrc/probe.cu",
            "replaces": f"tools/profile_pallas_probe.py:{line}",
            "launches": launches[name],
            "max_abs_err": err,
            "ms": result.ms,
            "plain_ms": plain_ms,
            "bound_ms": result.bound_ms,
            "bound_by": result.bound_by,
            "library_ms": result.library_ms if library else None,
        }

    got = probe.stream(x)
    torch.cuda.synchronize()
    _check_equal(torch, got, probe.stream_reference(x), f"stream {tuple(x.shape)}")
    entries["stream"] = entry("stream", 96, 0.0, results["stream"],
                              _time_ms(torch, lambda: probe.stream_reference(x), 3))

    perpix = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, xv, wt in (("perpix", x, w1), ("stacked2", stacked, w2)):
        got = probe.perpix(xv, wt)
        torch.cuda.synchronize()
        err = _check_close(torch, got, probe.perpix_reference(xv, wt),
                           f"perpix {tuple(xv.shape)}")
        plain_ms = _time_ms(torch, lambda: probe.perpix_reference(xv, wt), 3)
        perpix[name] = entry("perpix", 100, err, results[name], plain_ms)
        hh, ww, cc, nn = xv.shape
        plan = probe.perpix_plan(cc, nn, hh * ww, sms)
        perpix[name]["plan"] = {k: getattr(plan, k) for k in (
            "c_pad", "bn", "tiles", "smem_bytes", "grid")}
        log(f"[probe] perpix plan {tuple(xv.shape)}: {perpix[name]['plan']}")
    entries["perpix"] = perpix["perpix"]
    entries["perpix"]["stacked2"] = {k: perpix["stacked2"][k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "plan")}
    entries["perpix"]["stacked2"]["shape"] = list(stacked.shape)

    got, acc = probe.outerp(x)
    torch.cuda.synchronize()
    _check_equal(torch, got, probe.stream_reference(x), f"outerp pass-through {tuple(x.shape)}")
    del got
    xd = x.double()
    want = torch.einsum("hwcn,hwdn->cd", xd, xd)
    del xd
    acc_err = float((acc.double() - want).abs().max())
    rel = acc_err / float(want.abs().max())
    log(f"[probe] outerp sum {tuple(acc.shape)}: max abs err {acc_err:.6g} against a "
        f"float64 sum, {rel:.3g} of its largest entry")
    if not rel <= 1e-4:
        fail("the outerp kernel's sum disagrees with a float64 sum")
    again, acc2 = probe.outerp(x)
    same = torch.equal(acc, acc2)
    log(f"[probe] outerp: two calls give the same bits: {same}")
    if not same:
        fail("two calls of the outerp kernel differ")
    del again
    entries["outerp"] = entry("outerp", 113, acc_err, results["outerp"],
                              _time_ms(torch, lambda: probe.outerp_reference(x), 3),
                              library=False)
    plan = probe.outerp_plan(c, n, h * w, sms)
    entries["outerp"]["plan"] = {k: getattr(plan, k) for k in (
        "c_pad", "bn", "tiles", "smem_bytes", "grid")}
    log(f"[probe] outerp plan {tuple(x.shape)}: {entries['outerp']['plan']}")
    # beside it, not the same function: einsum of the fp32 sum alone
    entries["outerp"]["sum_einsum_ms"] = results["outerp"].library_ms
    entries["outerp"]["acc_rel_err"] = rel
    for e in entries.values():
        log(f"[probe] {e['name']}: kernel {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} ms, "
            f"library {e['library_ms']}, bound {e['bound_ms']:.4f} ms ({e['bound_by']})")
    return list(entries.values())


def _batch(torch, b, t, hw, n_classes_bg, gen, device):
    def frames():
        return torch.randint(0, 256, (b, t, hw, hw, 3), generator=gen,
                             device=gen.device, dtype=torch.uint8).to(device)

    def labels():
        return torch.randint(0, n_classes_bg, (b, t), generator=gen,
                             device=gen.device).to(device)

    def displ():
        return torch.randint(-2, 3, (b, t), generator=gen,
                             device=gen.device).float().to(device)

    return {"frame": frames(), "label": labels(), "labelD": displ(),
            "frame2": frames(), "label2": labels(), "labelD2": displ()}


def _trainer(torch, cfg, device, crop, seed):
    from tdeed_tpu_torch.models.tdeed import build_model
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_train_step

    torch.manual_seed(seed)
    model = build_model(cfg, device=device)
    opt, sched = make_optimizer(model.parameters(), cfg.learning_rate, 100, 10_000)
    step = make_train_step(
        model, opt, sched, crop_dim=crop, num_classes_bg=cfg.num_classes_bg,
        mixup=cfg.mixup, radi_displacement=cfg.radi_displacement, seed=seed,
    )
    return model, step


def agreement_phase(torch):
    """fp32 train step and predict on the card vs the CPU, small input."""
    from tdeed_tpu_torch import load_config
    from tdeed_tpu_torch.train.step import make_predict_step

    cfg = load_config("FineDiving_small", config_root=CONFIGS, dtype="float32")
    b, hw, crop = 2, 72, 64
    batch = _batch(torch, b, cfg.clip_len, hw, cfg.num_classes_bg,
                   torch.Generator().manual_seed(SEED), "cpu")

    def run(dev):
        model, step = _trainer(torch, cfg, dev, crop, SEED)
        draws = step.draw(batch)  # same generator seed: same draws on both
        predict = make_predict_step(model, crop_dim=crop,
                                    radi_displacement=cfg.radi_displacement)
        probs = predict(batch["frame"][:1], hflip=True)[1].cpu()
        loss = float(step({k: v.to(dev) for k, v in batch.items()}, draws)["loss"])
        return loss, probs

    (loss_cpu, probs_cpu), (loss_gpu, probs_gpu) = run("cpu"), run("cuda")
    rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    perr = float((probs_gpu - probs_cpu).abs().max())
    log(f"[agree] fp32 train step loss: cuda {loss_gpu:.7f} cpu {loss_cpu:.7f} "
        f"(rel {rel:.2e}); predict probs max abs diff {perr:.2e}")
    # The kernel and the plain chain may round a few augmented values to
    # neighbouring bf16 numbers, which moves the loss by ~1e-4 relative;
    # cuDNN's and the CPU's fp32 convs differ in summation order.
    if not (rel < 1e-3 and perr < 1e-4):
        fail("the CUDA path disagrees with the CPU path on a small input")


def serve_phase(torch, cfg, model):
    from tdeed_tpu_torch.train.step import make_predict_step

    predict = make_predict_step(model, crop_dim=cfg.crop_dim,
                                radi_displacement=cfg.radi_displacement)
    gen = torch.Generator().manual_seed(SEED + 2)
    times = []
    for _ in range(REQUESTS):
        frames = torch.randint(0, 256, (REQUEST_CLIPS, cfg.clip_len, FRAME, FRAME, 3),
                               generator=gen, dtype=torch.uint8)
        outs = []
        for hflip in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cls, probs = predict(frames, hflip=hflip)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            want = (REQUEST_CLIPS, cfg.clip_len, cfg.num_classes_bg)
            if tuple(probs.shape) != want or tuple(cls.shape) != want[:2]:
                fail(f"predict returned {tuple(probs.shape)}, want {want}")
            if not bool(torch.isfinite(probs).all()):
                fail("predict returned non-finite scores")
            if not bool(((probs >= 0) & (probs <= 1)).all()):
                fail("predict scores outside [0, 1]")
            outs.append(probs)
        if torch.equal(outs[0], outs[1]):
            fail("the hflip TTA pass returned the plain pass's scores")
    n = REQUEST_CLIPS * cfg.clip_len
    steady = times[2:]  # the first request pays cuDNN's first-call costs
    log(f"[serve] request of {REQUEST_CLIPS} clips x {cfg.clip_len} frames "
        f"(host uint8 {FRAME}x{FRAME}, crop {cfg.crop_dim}): "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms per pass; "
        f"steady {n * len(steady) / sum(steady):.0f} frames/s")


class _TimedLoad:
    """np.load as a frame decoder, with the seconds spent in it."""

    def __init__(self):
        self.seconds = 0.0

    def __call__(self, path):
        import numpy as np

        t0 = time.perf_counter()
        try:
            return np.load(path)
        finally:
            self.seconds += time.perf_counter() - t0


def _write_video(frame_dir, video, n, rng):
    """n random FRAME x FRAME uint8 frames, each np.save'd under the file
    name the FineDiving scheme resolves ('01__01' -> 01/01/0001.jpg, ...)."""
    import numpy as np

    path = os.path.join(frame_dir, video.replace("__", "/"))
    os.makedirs(path)
    for i in range(n):
        with open(os.path.join(path, f"{i + 1:04d}.jpg"), "wb") as fp:
            np.save(fp, rng.integers(0, 256, (FRAME, FRAME, 3), dtype=np.uint8))


def _read_windows(pred, frame_dir, video):
    """Seconds to read every window of the video on the host alone, as
    spot() reads them, from a cold decoded-frame cache."""
    from tdeed_tpu_torch.data.frames import load_window
    from tdeed_tpu_torch.data.loader import FrameCache

    cache = FrameCache(pred.cfg.decode_cache_mb << 20)
    stride, clip_len = pred.spec.eval_stride, pred.cfg.clip_len
    t0 = time.perf_counter()
    for s in pred._windows(SPOT_FRAMES):
        load_window(pred.spec, frame_dir, video, s, s + clip_len * stride, stride,
                    pred.decoder, pad=True, cache=cache)
    return time.perf_counter() - t0


def spot_phase(torch, cfg, model, smi):
    """Sliding-window spotting through SpottingPredictor.spot(), then
    evaluate() over a split, with the flagship model's weights.

    The card's machine has numpy but no PIL, cv2 or libjpeg, so the frames
    are synthetic: one FineDiving-layout video of SPOT_FRAMES random
    256x256 uint8 frames from a seeded numpy generator, under a temporary
    directory in build/, each written with np.save at the path the
    FineDiving scheme resolves, and the predictor's decoder (the seam the
    JAX class also exposes as ``self.decoder``) is an np.load reader. The
    files sit in the page cache, so "decode" here is a memory read. Each
    timed call starts with an empty decoded-frame cache, as a new video
    would.
    """
    import tempfile

    import numpy as np

    from tdeed_tpu_torch.data.loader import FrameCache
    from tdeed_tpu_torch.infer.evaluate import evaluate
    from tdeed_tpu_torch.infer.predictor import SpottingPredictor
    from tdeed_tpu_torch.infer.windows import VideoWindows
    from tdeed_tpu_torch.kernels.augment import photometric

    classes = {f"class{i}": i for i in range(1, cfg.num_classes + 1)}
    pred = SpottingPredictor(cfg, model.state_dict(), classes,
                             device=next(model.parameters()).device)
    load = _TimedLoad()
    pred.decoder = load
    rng = np.random.default_rng(SEED + 4)
    k1_launches = photometric.launches
    os.makedirs(REPO / "build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as root:
        frame_dir = os.path.join(root, "frames")
        video = "01__01"
        _write_video(frame_dir, video, SPOT_FRAMES, rng)
        n_windows = len(pred._windows(SPOT_FRAMES))
        every = dict(nms="none", threshold=0.0)  # every (frame, class) score
        for mode, tta in (("tta", True), ("plain", False)):
            calls = {}
            for name, kw in (("host", dict(device_aggregate=False, **every)),
                             ("device", every), ("device again", every),
                             ("default snms", {})):
                pred._cache = FrameCache(cfg.decode_cache_mb << 20)
                load.seconds = 0.0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                events = pred.spot(frame_dir, video, SPOT_FRAMES, hflip_tta=tta, **kw)
                wall = time.perf_counter() - t0  # spot() ends reading scores back
                calls[name] = (events, wall, load.seconds)
            host, dev, again = (calls[k][0] for k in ("host", "device", "device again"))
            if len(dev) != SPOT_FRAMES * len(classes):
                fail(f"spot() with threshold 0 returned {len(dev)} events")
            if dev != host:
                fail(f"spot() {mode}: device and host aggregation give different scores")
            if again != dev:
                fail(f"spot() {mode}: two calls give different scores")
            spotted = calls["default snms"][0]
            if not spotted:
                fail(f"spot() {mode} spotted no event")
            for e in dev + spotted:
                if not (e["label"] in classes and 0 <= e["frame"] < SPOT_FRAMES
                        and 0.0 <= e["score"] <= 1.0):
                    fail(f"spot() {mode} returned an invalid event {e}")
            bs = 1 if tta else pred.batch_size
            log(f"[spot] {mode} (batch {bs}, {2 if tta else 1} pass(es)), {SPOT_FRAMES} "
                f"frames of {FRAME}x{FRAME} uint8, {n_windows} windows: "
                + "; ".join(f"{k} {w * 1e3:.1f} ms ({SPOT_FRAMES / w:.0f} frames/s, "
                            f"decode {d / w:.1%} of wall)" for k, (_, w, d) in calls.items())
                + f"; {len(spotted)} events after SNMS; device == host bits, two calls "
                f"the same bits; {smi}")
            passes, n_batches = (2 if tta else 1), -(-n_windows // bs)
            x = torch.zeros((bs, cfg.clip_len, FRAME, FRAME, 3), dtype=torch.uint8,
                            device=pred.device)
            fwd_ms = _time_ms(torch, lambda: pred._predict(x, False), 5)
            log(f"[spot] {mode}, where the time goes: the window reads alone (host, cold "
                f"frame cache) {_read_windows(pred, frame_dir, video) * 1e3:.1f} ms; the "
                f"forward {fwd_ms:.2f} ms per batch of {bs} on the card, "
                f"{fwd_ms * n_batches * passes:.1f} ms for the video's {n_batches} batches "
                f"x {passes} pass(es)")

        split = []
        for name, n in ((video, SPOT_FRAMES), ("02__01", EVAL_FRAMES)):
            if name != video:
                _write_video(frame_dir, name, n, rng)
            events = sorted(({"frame": int(rng.integers(0, n)),
                              "label": f"class{int(rng.integers(1, len(classes) + 1))}"}
                             for _ in range(6)), key=lambda e: e["frame"])
            split.append({"video": name, "num_frames": n, "fps": 25.0,
                          "events": events, "num_events": len(events)})
        label_file = os.path.join(root, "val.json")
        with open(label_file, "w") as fp:
            json.dump(split, fp)
        data = VideoWindows(
            cfg.dataset, label_file, frame_dir, cfg.clip_len,
            overlap_len=pred.spec.eval_overlap_len(cfg.clip_len),
            stride=pred.spec.eval_stride, decoder=np.load,
        )
        t0 = time.perf_counter()
        m = evaluate(pred.predict_fn, data, "val", classes, printed=False)
        wall = time.perf_counter() - t0
    if not (math.isfinite(m) and 0.0 <= m <= 1.0):
        fail(f"evaluate() returned mAP {m}")
    log(f"[spot] evaluate() val, 2 videos ({SPOT_FRAMES} + {EVAL_FRAMES} frames, {len(data)} "
        f"windows, batch 4): mAP {m:.4f} in {wall * 1e3:.1f} ms; {smi}")
    if photometric.launches != k1_launches:
        fail("spotting launched the photometric kernel")


def train_phase(torch, cfg, model, step):
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    batch = _batch(torch, cfg.batch_size, cfg.clip_len, FRAME, cfg.num_classes_bg,
                   gen, "cuda")
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(step(batch)["loss"])  # float() waits for the step
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite training loss: {losses}")
    n = cfg.batch_size * cfg.clip_len
    log(f"[train] batch {cfg.batch_size} x clip {cfg.clip_len}, {FRAME}^2 uint8 "
        f"-> crop {cfg.crop_dim}, mixup {cfg.mixup}, {cfg.dtype}: losses "
        f"{', '.join(f'{v:.4f}' for v in losses)}; step times "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms; last step "
        f"{n / times[-1]:.0f} frames/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def main() -> int:
    import torch

    smi = device_phase(torch)
    try:
        import tdeed_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port is not importable here ({e}); run from the repository root")
    from tdeed_tpu_torch import load_config
    from tdeed_tpu_torch.kernels.augment import photometric

    build_phase()
    k1 = kernel_phase(torch)
    probes = probe_phase(torch)
    torch.cuda.empty_cache()
    agreement_phase(torch)

    cfg = load_config("FineDiving_small", config_root=CONFIGS)
    model, step = _trainer(torch, cfg, "cuda", cfg.crop_dim, SEED)
    log(f"[model] FineDiving_small: {cfg.feature_arch}, clip {cfg.clip_len}, "
        f"crop {cfg.crop_dim}, {sum(p.numel() for p in model.parameters())} params, "
        f"{cfg.dtype} compute")
    photometric.launches = 0
    serve_phase(torch, cfg, model)
    spot_phase(torch, cfg, model, smi)
    train_phase(torch, cfg, model, step)
    k1["launches"] = photometric.launches
    if k1["launches"] < TRAIN_STEPS:
        fail(f"the training steps launched the photometric kernel {k1['launches']} times")

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "tdeed_tpu"))
    if leaked:
        fail(f"JAX or the JAX package was imported: {leaked}")
    kernels = [k1, *probes]
    for k in kernels:
        k["lib_ms"] = k["library_ms"]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
