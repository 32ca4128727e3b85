#!/usr/bin/env python3
"""Smoke run of the PyTorch port (tdeed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: a CUDA card is required (no CPU path); prints the card's name
     and power limit and the TF32 switches;
  2. build: compiles the photometric kernel (csrc/photometric.cu), the
     probe kernels (csrc/probe.cu), the BatchNorm kernels
     (csrc/batchnorm.cu) and the upsample kernels (csrc/upsample.cu) with
     nvcc, one process each, together, and the squeeze-and-excitation
     kernels (csrc/se.cu);
  3. kernel: the photometric kernel against its plain PyTorch version on
     the card, all 64 gate combinations (hue, saturation, brightness,
     contrast, blur, flip), uint8 and bf16 input, 224x224, 448x796 and
     16x2200 (bf16 there in 2 column segments); then at the flagship shape
     (8, 100, 224, 224, 3) bf16 against the plain version and against its
     own second call (the same bits), and both timed there; the kernel also
     with every gate on in every clip, and at SoccerNet Ball's full frames
     (8, 100, 448, 796, 3) bf16;
  3a. bn: the four training BatchNorm kernels (kernels/batchnorm.py) at
     each benchmark cell's largest BatchNorm, the stem, bf16 with ReLU,
     against their plain twins (the moments and sums against float64, y
     bit for bit and dx within 1 bf16 ulp given the kernel's statistics),
     each timed beside its bound and its twin;
     their launches are counted on each later phase's paths, and every
     path that trains must launch them;
  3c. up: the SGP-Mixer's upsample kernels (kernels/upsample.py) at both
     mixers' shapes (25 -> 50, 50 -> 100) and both cells' batches (8, 4),
     bf16 from the mixer's channels-innermost view: the forward within 1
     bf16 ulp of F.interpolate at its terms' magnitude, the backward within
     one rounding of float64 and the same bits twice; then each direction
     timed from a CUDA graph of 20 calls beside F.interpolate (forward and
     ATen's backward), the fp32 align-corners GEMM with its casts, the
     bytes' bound and one empty launch; the phases 5-7 must launch both;
  3d. se: the squeeze-and-excitation kernels (kernels/se.py) at every
     block shape of the three benchmark cells, bf16 in channels_last: the
     product bit for bit ATen's, the gate's sums against float64, x's
     gradient within 1 bf16 ulp of the twin, SEModule's forward bit for bit
     the stock ops'; each kernel, and the SE's forward and backward through
     them and through the stock ops SEModule runs on the CPU, timed from a
     CUDA graph of 20 calls beside the bytes' bound; the phases 5-7 must
     launch all three;
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
     synthetic 600-frame video (np.save'd frames read by np.load, the
     decode-free baseline of 11d) with the hflip TTA (batch 1, 2 passes) and
     without (batch 4): device and host aggregation give the same bits,
     two calls give the same bits, every event is a known class at a frame
     of the video with a score in [0, 1]; then evaluate() over a 2-video
     split gives a finite mAP in [0, 1]. It must not launch the
     photometric kernel (a training augmentation);
  6. train: 3 steps of the flagship training step (batch 8 x clip 100,
     256x256 uint8 cropped to 224, mixup on, bf16 compute, AdamW), which
     must go through the CUDA kernel; then 2 steps at acc_grad_iter=2
     (2 micro-batches of 4), which must launch it twice a step;
  7. cli: the training CLI (tdeed_tpu_torch.cli.train) on the card, in
     process, over a synthetic FineDiving-layout dataset (3 train, 1 val
     and 1 test video of 300 frames of 256x256 uint8, np.save'd under the
     .jpg names and read by np.load) with FineDiving_small at full width
     and only its paths, store mode and epochs changed (CLI_CONFIG): store
     mode, 2 epochs of 6 optimizer steps, then --resume for a third, which
     must start at step 12 and end at step 18; then the predict CLI
     (tdeed_tpu_torch.cli.predict) twice over the test split from the
     run's checkpoint_best, with the same events both times. Artifacts,
     losses and mAPs are checked; the photometric kernel must launch at
     least once per optimizer step. The CLI's loader is also timed alone
     (cold and warm frame cache, on the host and onto the card).
  8. snb: the SoccerNet Ball challenge path at full width: the training CLI
     over configs/SoccerNetBall/SoccerNetBall_challenge2.json (rny008_gsf,
     the FC2 double head for joint training with SoccerNet, batch 2 x clip
     100 of full 448x796 frames, mixup, bf16, displacement radius 4) with
     only its paths, store mode and epochs changed (SNB_CONFIG), over
     synthetic games (SoccerNet Ball: 1 train, 1 val, the 2 test games the
     challenge scorer names and 1 challenge game of SNB_GAME_FRAMES frames;
     SoccerNet: 1 train and 1 val game of two halves), np.save'd under the
     .jpg names: store mode, 2 epochs of 3 optimizer steps with val mAP and
     checkpoint_best, the test tail through evaluate_snb; then the
     challenge CLI (tdeed_tpu_torch.cli.evaluate_challenge), which must
     write the challenge game's results_spotting.json. The photometric
     kernel must launch once per micro-batch; one step's launch, at (2,
     100, 448, 796, 3) bf16, is held against the plain chain and timed.
     Then the same step alone, with its batch on the card: step times and
     peak memory.
  9. trunks, checkpoint_backbone and export: first the agreement check of
     phase 4 for rny002_gsm (GSM gates seeded nonzero, as everywhere
     here: at their zero init GSM only regroups channels); then
     9a: FineDiving_small at full width with the rny002_gsm, plain rny002
     and rny008_gsm trunks: a timm-layout file from a seed through
     checkpoint.load_backbone (each written trunk tensor equal to the
     file's), 3 train steps with the batch on the card (step times, peak
     memory, parameters; one photometric launch a step) and one 4-clip
     predict request of host uint8; 9b: one SoccerNetBall_challenge2 step
     at full frames with checkpoint_backbone off and one with it on, same
     weights, batch and draws: the same loss (1e-3 relative), running
     statistics and BN counters, and a lower peak with it on; 9c:
     FineDiving_small exported on the card (infer.export, batch 4, both
     passes, 256^2 stored frames), loaded by a fresh ExportedPredictor and
     held against the eager predict step (probs within 1e-3): export
     seconds, artifact bytes, median ms of 10 calls of each.
  10. data parallelism (tdeed_tpu_torch.parallel) at the flagship's full
     width (FineDiving_small, batch 8 x clip 100, 256^2 uint8 cropped to
     224, bf16, mixup): 10a: 3 train steps over 2 spawned ranks, 4 clips
     each (NCCL on cuda:0 and cuda:1 with two cards, else gloo with both
     on cuda:0), held at step 0 against the one-process step on the
     global batch with the same weights and draws (loss, running
     statistics, averaged gradients, updated weights, within DP_BOUNDS;
     beside them the one-process step's distance from its own rerun and
     from its run on the batch's halves interleaved, the noise of another
     order of sums, and how far a half-size batch moves the eval scores), one photometric launch per rank per step, each
     rank's and the one-process step times; then the same at fp32, cut to
     DP_FP32, for a tight check of the arithmetic; 10b: cli.train --distributed at world
     size 1 over NCCL (the torchrun environment set here) over the
     phase-7 dataset, 1 epoch of 1 step, then --resume for a second with
     val mAP: bare checkpoint keys, from_run loads checkpoint_best; 10c:
     with two cards spot() over n_devices=2 against 1, bit for bit; with
     one, a line saying why it did not run.
  11. the host data tools over real JPEG files, no decoder seam: 11a: the
     toolchain the native JPEG decoder needs (g++, jpeglib.h, libjpeg, the
     libjpeg Pillow bundles) and its build (tdeed_tpu_torch/native/jpeg.py);
     where it cannot be built, get_decoder('native') must raise with the
     build's message, 11b-11d do not run and 11e reads phase 7's np.load
     seam; 11b: every committed fixture JPEG (native/fixtures/) against its
     manifest, bit for bit with the manifest's libjpeg.so.62 (else within
     OTHER_LIBJPEG_*), then decode and decode_batch of 100 frames on 1, 4
     and 8 threads timed at 256x256 and 448x796, beside PIL and OpenCV;
     11c: phase 7's training CLI run (store, 2 epochs) over the same layout
     with every frame a symbolic link to a committed 256x256 JPEG, read by
     the decoder the config names ('auto': native), its warm epoch beside
     phase 7's, and its loader alone; 11d: spot() over a 600-frame video of
     such links with the predictor's own decoder, beside phase 5b; 11e:
     tools.validate_reference_checkpoint on a reference-layout .pt of the
     flagship weights over 11c's test split (its mAP, then --expect that
     mAP: "within"), tools.overfit_check at 100 steps (its default 150 take
     over 20 s on the card; one photometric launch a step) and
     tools.convergence_check with its default 400 steps.
  12. the measuring tools (tdeed_tpu_torch/tools/), in process at reduced
     counts: bench (3 + 10 flagship steps, predict 20 + 20 calls, SoccerNet
     Ball challenge training at acc_grad_iter 2 for 2 + 3 steps, the input
     path on 120 frames), bench_snb's k1 and plain variants at
     acc_grad_iter 2 (2 + 3 steps), bench_input on 120 frames, profile_step
     with a torch.profiler trace of 3 steps, and profile_infer at SoccerNet
     Ball's geometry at batch 4 with the window aggregation: every JSON
     line parses and names phase 1's card, every number is finite and
     positive, K1 launches once a micro-batch on the k1 paths and never on
     plain, the trace holds device time with K1's kernel among its ops
     (its time inside the step joins the kernel's line), and device and
     host aggregation give the same bits.

The line before the last is a JSON object with each kernel's route, the
TPU kernel it replaces, its launches on its paths (phases 5-7, phase 8,
phase 9, phase 10, phase 11 and phase 12 for the photometric
kernel, each counted from 0, and their sum; the
probe tool's run for the probe kernels), its
largest error against the plain version, its time, the plain version's,
the one PyTorch call's that computes the same function (null where there
is none) and the card's bound for the same work; the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or outside the
repository, it exits non-zero and prints neither.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
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
ACC_STEPS = 2  # flagship steps at acc_grad_iter=2
CLI_VIDEOS = (("train", 3), ("val", 1), ("test", 1))
CLI_FRAMES = 300  # frames of each video of the CLI phase's dataset
CLI_EVENT_EVERY = 10  # one event every 10 frames: val mAP above 0 from random weights
# the keys of configs/FineDiving/FineDiving_small.json the CLI phase changes,
# besides the paths and store_mode: 4,800 frames = 48 clips = 6 optimizer
# steps an epoch; val mAP (the config's criterion) from epoch 1
CLI_CONFIG = dict(epoch_num_frames=4800, num_epochs=2, warm_up_epochs=1, start_val_epoch=1)
CLI_RESUME_EPOCHS = 3
SPOT_FRAMES = 600  # the video spot() runs over; evaluate() adds one of EVAL_FRAMES
EVAL_FRAMES = 300
SNB_FRAME = (448, 796)  # SoccerNet Ball's full frames (crop_dim -1)
SNB_GAME_FRAMES = 250  # frames of each synthetic SoccerNet Ball game
SNB_EVENT_EVERY = 10  # source frames between two events: mAPs above 0 from random weights
# SoccerNet trains at stride 12, so a clip of 100 spans 1,200 frames and a
# half needs at least 1,082 for one clip; its halves hold SN_HALF_FRAMES
# files, hard links to SN_POOL distinct frames
SN_HALF_FRAMES = 1300
SN_POOL = 32
SN_EVENT_EVERY = 120  # one event every 10 strided frames
# the keys of configs/SoccerNetBall/SoccerNetBall_challenge2.json phase 8
# changes, besides the paths and store_mode: 600 frames = 6 clips = 3
# optimizer steps of batch 2 an epoch; val mAP (the criterion) from epoch 1
SNB_CONFIG = dict(epoch_num_frames=600, num_epochs=2, warm_up_epochs=1, start_val_epoch=1)
SNB_ALONE_STEPS = 3  # the phase-8 step alone, batch on the card
PHASE9_ARCHS = ("rny002_gsm", "rny002", "rny008_gsm")  # FineDiving_small at full width
PHASE9_STEPS = 3  # train steps of each phase-9 trunk, and of each 9b setting
EXPORT_CLIPS = 4  # the exported programs' batch (phase 9c)
EXPORT_CALLS = 10
KERNEL_SOURCES = ("photometric", "probe", "batchnorm", "upsample", "se")
# phase 11: the host data tools over the committed JPEG fixtures
DECODE_BATCH = 100  # frames of each timed decode_batch
DECODE_THREADS = (1, 4, 8)
DECODE_REPEATS = 3  # each decode timing is the median of 3
# A libjpeg of another ABI than the manifest's (libjpeg.so.62) may round
# the IDCT differently by 1 (IEEE 1180 accuracy) and upsample the 4:2:0
# chroma with another filter (libjpeg 7+ scales it in the DCT domain); on
# the fixtures' smooth gradients with +-20 noise that moves a value by at
# most the chroma step between neighbouring samples, <= 16, and the mean
# absolute difference stays under 2
OTHER_LIBJPEG_MAX_ABS = 16
OTHER_LIBJPEG_MEAN_ABS = 2.0
# tools.overfit_check with --steps 100, one photometric launch a step: its
# default 150 steps take 21-26 s on the card, and 100 pass its rule there
OVERFIT_STEPS = 100
# phase 10: data parallelism at the flagship's full width
DP_RANKS = 2
DP_STEPS = 3
DP_TIMEOUT_S = 600  # the ranks' processes, spawned, built and stepped
# 10a's bounds for the 2-rank step 0 against the one-process step on the
# global batch. The two differ only in the order of sums: BatchNorm's
# moments are the mean of the ranks' fp32 means, the gradients the mean of
# theirs. bf16: that can move a channel's bf16 scale by one rounding, and
# such differences carry through the trunk (2^-8 = 3.9e-3 relative each);
# Adam's first step moves each weight by lr(0) = 8e-6 times the sign of
# its gradient, so a weight either matches (within a quarter step) or took
# the other sign where its gradient is below the noise. The gradient
# distance may also reach DP_FLOOR_RATIO times the larger of the
# one-process step's distance from its own rerun and from its run on the
# batch's halves interleaved: the noise of this step under another order.
# fp32 (cut to DP_FP32 = (global batch, frame, crop), clip 100, the
# agreement phase's size): the tight check of the arithmetic, at the CPU
# tests' bounds (tests/test_torch_ddp.py).
DP_FP32 = (4, 72, 64)
DP_BOUNDS = {
    "bf16": {"loss": 1e-2, "stats": 2e-2, "grads": 1e-1, "weights": 0.9},
    "fp32": {"loss": 1e-4, "stats": 1e-4, "grads": 5e-2, "weights": 0.99},
}
DP_FLOOR_RATIO = 2.0
# 10b: the CLI's epoch over the phase-7 dataset: 800 frames = 8 clips = 1 step
DP_CLI_CONFIG = dict(CLI_CONFIG, epoch_num_frames=800, num_epochs=1)
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
    try:
        from tdeed_tpu_torch.utils.profiling import card
    except ImportError as e:
        fail(f"the port is not importable here ({e}); run from the repository root")
    smi = card()["smi"]
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


# the largest trunk BatchNorm of each benchmark cell, the stem's (frames,
# 32, H/2, W/2) bf16: FineDiving's 8 x 100 crops of 224^2, SoccerNet Ball's
# 4 x 100 full 448 x 796 frames
BN_STEMS = (("FineDiving_small", (800, 32, 112, 112)),
            ("SoccerNetBall_challenge1", (400, 32, 224, 398)))
BN_BYTES = {"stats": 2, "apply": 4, "grad_sums": 4, "grad_apply": 6}  # a bf16 element


def bn_launches():
    """The four BatchNorm kernels' launch counters, by kernel."""
    from tdeed_tpu_torch.kernels import batchnorm as bn

    return {k: getattr(bn, f"bn_{k}").launches for k in BN_BYTES}


def bn_kernel_phase(torch):
    """The BatchNorm kernels (csrc/batchnorm.cu) at each cell's stem, with
    ReLU, against their plain twins: the moments and the gradient's sums
    against a float64 sum (1e-5 of the terms' magnitudes), y bit for bit
    and dx within 1 bf16 ulp given the kernel's statistics; then each
    kernel timed beside its bound (its bf16 bytes once each way at 3.35
    TB/s) and its twin."""
    from tdeed_tpu_torch.kernels import batchnorm as bn
    from tdeed_tpu_torch.utils.profiling import PEAK_BYTES_PER_S

    dev = torch.device("cuda")
    out = {"name": "batchnorm", "route": "cuda", "source": "tdeed_tpu_torch/csrc/batchnorm.cu",
           "replaces": None, "library_ms": None, "max_abs_err": 0.0, "cells": {}}
    for cell, (n, c, h, w) in BN_STEMS:
        gen = torch.Generator(device=dev).manual_seed(SEED + c)
        x = (torch.randn((n, h, w, c), generator=gen, device=dev) * 1.5 + 0.3).to(
            torch.bfloat16).permute(0, 3, 1, 2)
        gy = torch.randn((n, h, w, c), generator=gen, device=dev).to(
            torch.bfloat16).permute(0, 3, 1, 2)
        weight = torch.rand(c, generator=gen, device=dev) + 0.5
        bias = 0.5 * torch.randn(c, generator=gen, device=dev)
        args = (weight, bias, 1e-5, True)
        rows = x.numel() // c

        moments = bn.bn_stats(x)
        y, stats = bn.bn_apply(x, moments, *args)
        sums = bn.bn_grad_sums(x, gy, stats, *args)
        dx, dw, db = bn.bn_grad_apply(x, gy, stats, *args, sums, sums, rows)
        torch.cuda.synchronize()
        dims = [0, 2, 3]
        sum_err = 0.0
        for what, got, terms in (("moments", moments, (x, x.double().square())),
                                 ("sums", sums, None)):
            if terms is None:
                dz = bn._masked(x, gy, stats, *args)[0].double()
                terms = (dz, dz * x.double())
            want = torch.stack([t.double().mean(dims) if what == "moments" else
                                t.double().sum(dims) for t in terms])
            mag = torch.stack([t.double().abs().mean(dims) if what == "moments" else
                               t.double().abs().sum(dims) for t in terms])
            rel = float(((got.double() - want).abs() / mag).max())
            sum_err = max(sum_err, rel)
            del want, mag, terms
            if rel > 1e-5:
                fail(f"bn {cell}: the kernel's {what} are {rel:.2e} off a float64 sum")
        same_y = torch.equal(y, bn.bn_apply_reference(x, moments, *args)[0])
        if not same_y:
            fail(f"bn {cell}: the kernel's y differs from its twin's given its statistics")
        dx_t = bn.bn_grad_apply_reference(x, gy, stats, *args, sums, sums, rows)[0]
        err = _check_close(torch, dx, dx_t, f"bn {cell} stem {(n, c, h, w)} dx")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        del dx_t, dx, y

        kernels = {
            "stats": lambda: bn.bn_stats(x),
            "apply": lambda: bn.bn_apply(x, moments, *args),
            "grad_sums": lambda: bn.bn_grad_sums(x, gy, stats, *args),
            "grad_apply": lambda: bn.bn_grad_apply(x, gy, stats, *args, sums, sums, rows),
        }
        twins = {
            "stats": lambda: bn.bn_stats_reference(x),
            "apply": lambda: bn.bn_apply_reference(x, moments, *args),
            "grad_sums": lambda: bn.bn_grad_sums_reference(x, gy, stats, *args),
            "grad_apply": lambda: bn.bn_grad_apply_reference(x, gy, stats, *args, sums, sums,
                                                             rows),
        }

        row = {"shape": [n, c, h, w], "sum_rel_err": sum_err, "kernels": {}}
        for k, fn in kernels.items():
            ms = _time_ms(torch, fn, 20)
            bound_ms = BN_BYTES[k] * x.numel() / PEAK_BYTES_PER_S * 1e3
            twin_ms = _time_ms(torch, twins[k], 3)
            row["kernels"][k] = {"ms": ms, "bound_ms": bound_ms, "twin_ms": twin_ms}
        row["ms"] = sum(v["ms"] for v in row["kernels"].values())
        row["bound_ms"] = 16 * x.numel() / PEAK_BYTES_PER_S * 1e3
        row["twin_ms"] = sum(v["twin_ms"] for v in row["kernels"].values())
        out["cells"][cell] = row
        log(f"[bn] {cell} stem {(n, c, h, w)} bf16 + ReLU: sums within {sum_err:.2e} of "
            f"float64, y bit for bit; " + "; ".join(
                f"{k} {v['ms']:.3f} ms ({v['bound_ms'] / v['ms']:.0%} of {v['bound_ms']:.3f}), "
                f"twin {v['twin_ms']:.3f}" for k, v in row["kernels"].items())
            + f"; all four {row['ms']:.3f} ms against {row['bound_ms']:.3f} ms of bound "
            f"({row['bound_ms'] / row['ms']:.0%}), the twins {row['twin_ms']:.3f}")
        del x, gy
        torch.cuda.empty_cache()
    return out


# the SGP-Mixers' upsample in each cell: (batch, channels, T_in, T_out)
UP_SHAPES = (("FineDiving_small", ((8, 368, 25, 50), (8, 368, 50, 100))),
             ("SoccerNetBall_challenge1", ((4, 368, 25, 50), (4, 368, 50, 100))))
UP_CALLS = 20  # calls a CUDA graph holds, for the upsample timings


def _graph_ms(torch, fn, reps=5):
    """Device ms a call of ``fn``, replayed from a CUDA graph of UP_CALLS
    calls (as the training step's graphs run the mixers), after two eager
    warm-up calls on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(UP_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * UP_CALLS)


def up_kernel_phase(torch):
    """The upsample kernels (csrc/upsample.cu) at the mixers' shapes in both
    cells, bf16 from the mixer's (B, T, C) activation seen as (B, C, T):
    the forward against F.interpolate, the backward against float64 and
    against itself; each direction timed beside F.interpolate's ("plain"),
    the fp32 GEMM by the align-corners matrix with its casts ("library"),
    the bytes' bound and one empty launch."""
    import torch.nn.functional as F

    from tdeed_tpu_torch.kernels import upsample
    from tdeed_tpu_torch.utils.profiling import PEAK_BYTES_PER_S

    dev = torch.device("cuda")
    out = {"name": "upsample", "route": "cuda", "source": "tdeed_tpu_torch/csrc/upsample.cu",
           "replaces": None, "max_abs_err": 0.0, "cells": {}}
    one = torch.empty(1, device=dev)
    empty_ms = _graph_ms(torch, lambda: one.zero_())
    worst = {"forward_ulps": 0.0, "backward_bound_share": 0.0}
    for cell, shapes in UP_SHAPES:
        rows = []
        for b, c, t_in, t_out in shapes:
            gen = torch.Generator(device=dev).manual_seed(SEED + t_in)
            x = torch.randn((b, t_in, c), generator=gen, device=dev).to(
                torch.bfloat16).transpose(1, 2)
            dy = torch.randn((b, c, t_out), generator=gen, device=dev).to(torch.bfloat16)
            y = upsample.upsample_forward(x, t_out)
            want = F.interpolate(x, size=t_out, mode="linear", align_corners=True)
            mag = F.interpolate(x.abs().float(), size=t_out, mode="linear", align_corners=True)
            ulps = float(((y.double() - want.double()).abs()
                          / torch.exp2(torch.floor(torch.log2(mag.double())) - 7)).max())
            same = float((y == want).float().mean())
            dx = upsample.upsample_backward(dy, t_in)
            x64 = x.detach().double().requires_grad_()
            y64 = F.interpolate(x64, size=t_out, mode="linear", align_corners=True)
            want64 = torch.autograd.grad(y64, x64, dy.double())[0]
            mag64 = torch.autograd.grad(y64, x64, dy.double().abs())[0]
            bound = (torch.exp2(torch.floor(torch.log2(mag64)) - 7)
                     + (2 * t_out / (t_in - 1) + 3) * 2.0 ** -24 * mag64)
            share = float(((dx.double() - want64).abs() / bound).max())
            twice = torch.equal(dx, upsample.upsample_backward(dy, t_in))
            eager_err = float((torch.ops.aten.upsample_linear1d_backward(
                dy, [t_out], [b, c, t_in], True).double() - want64).abs().max())
            err = float((dx.double() - want64).abs().max())
            out["max_abs_err"] = max(out["max_abs_err"], err)
            worst["forward_ulps"] = max(worst["forward_ulps"], ulps)
            worst["backward_bound_share"] = max(worst["backward_bound_share"], share)
            log(f"[up] {cell} {(b, c, t_in, t_out)}: forward {ulps:.2f} bf16 ulps of "
                f"F.interpolate at most, {same:.2%} bit-equal; backward {share:.3f} of its "
                f"bound at most, max abs err {err:.3g} against float64 (ATen's "
                f"{eager_err:.3g}), the same bits twice {twice}")
            if ulps > 1.0 or share > 1.0 or not twice:
                fail(f"up {cell} {(b, c, t_in, t_out)}: the kernels disagree")

            w = torch.zeros((t_out, t_in), dtype=torch.float64)
            for j, terms in enumerate(upsample.gather_pairs(t_in, t_out)):
                for i, wt in terms:
                    w[i, j] += wt
            w = w.float().to(dev)
            wt_t = w.t().contiguous()
            nbytes = 2 * b * c * (t_in + t_out)
            row = {"shape": [b, c, t_in, t_out], "bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
                   "empty_launch_ms": empty_ms}
            for way, kernel, plain, gemm in (
                    ("forward", lambda: upsample.upsample_forward(x, t_out),
                     lambda: F.interpolate(x, size=t_out, mode="linear", align_corners=True),
                     lambda: torch.matmul(x.float(), wt_t).to(torch.bfloat16)),
                    ("backward", lambda: upsample.upsample_backward(dy, t_in),
                     lambda: torch.ops.aten.upsample_linear1d_backward(
                         dy, [t_out], [b, c, t_in], True),
                     lambda: torch.matmul(dy.float(), w).to(torch.bfloat16))):
                row[way] = {"ms": _graph_ms(torch, kernel), "plain_ms": _graph_ms(torch, plain),
                            "library_ms": _graph_ms(torch, gemm)}
            rows.append(row)
            log(f"[up] {cell} {(b, c, t_in, t_out)} device ms a call (graph of {UP_CALLS}): "
                + "; ".join(f"{way} {row[way]['ms']:.4f}, F.interpolate "
                            f"{row[way]['plain_ms']:.4f}, fp32 GEMM {row[way]['library_ms']:.4f}"
                            for way in ("forward", "backward"))
                + f"; bound {row['bound_ms']:.5f} (bytes), empty launch {empty_ms:.4f}")
            del x, dy, y, want, dx
        out["cells"][cell] = rows
    out.update(worst)
    per_step = {cell: {k: sum(r[way][k] for r in rows for way in ("forward", "backward"))
                       for k in ("ms", "plain_ms", "library_ms")}
                for cell, rows in out["cells"].items()}
    out["per_micro_batch"] = per_step
    out["ms"] = per_step["FineDiving_small"]["ms"]
    out["plain_ms"] = per_step["FineDiving_small"]["plain_ms"]
    out["library_ms"] = per_step["FineDiving_small"]["library_ms"]
    log(f"[up] both mixers, forward and backward, a micro-batch: {json.dumps(per_step)}")
    return out


# the trunk's SE in each cell: (frames a micro-batch, ((H, W, C, blocks), ...))
SE_SHAPES = (("FineDiving_small", 800, ((56, 56, 24, 1), (28, 28, 56, 1), (14, 14, 152, 4),
                                        (7, 7, 368, 7))),
             ("SoccerNetBall_challenge1", 400, ((112, 199, 24, 1), (56, 100, 56, 1),
                                                (28, 50, 152, 4), (14, 25, 368, 7))),
             ("SoccerNetBall_challenge2", 200, ((112, 199, 64, 1), (56, 100, 128, 3),
                                                (28, 50, 320, 8), (14, 25, 768, 2))))
# passes over the tensor: each kernel's, and the SE's with ATen's mean
SE_PASSES = {"excite": 2, "grad_sums": 2, "grad_apply": 2}
SE_ALL_PASSES = 7


def se_kernel_phase(torch):
    """The SE kernels (csrc/se.cu) at every block shape of the three cells,
    bf16 in channels_last: the product bit for bit ATen's, the gate's sums
    against float64 (fp32 sums: 1e-5 of the terms' magnitudes), x's
    gradient within 1 bf16 ulp of its twin, SEModule's forward bit for bit
    the stock ops'; then each kernel, and the SE's forward and backward
    through the kernels and through ATen's stock ops ("plain"), device ms a
    call from a CUDA graph, beside the bound (its bf16 passes at 3.35
    TB/s)."""
    from tdeed_tpu_torch.kernels import se
    from tdeed_tpu_torch.models.regnet import SEModule
    from tdeed_tpu_torch.utils.profiling import PEAK_BYTES_PER_S

    dev = torch.device("cuda")
    out = {"name": "se", "route": "cuda", "source": "tdeed_tpu_torch/csrc/se.cu",
           "replaces": None, "library_ms": None, "max_abs_err": 0.0, "cells": {}}
    for cell, n, shapes in SE_SHAPES:
        rows = []
        for h, w, c, blocks in shapes:
            gen = torch.Generator(device=dev).manual_seed(SEED + c)
            x = (torch.randn((n, h, w, c), generator=gen, device=dev) * 1.5 + 0.3).to(
                torch.bfloat16).permute(0, 3, 1, 2)
            gy = torch.randn((n, h, w, c), generator=gen, device=dev).to(
                torch.bfloat16).permute(0, 3, 1, 2)
            s = torch.rand((n, c), generator=gen, device=dev).to(torch.bfloat16)
            dm = torch.randn((n, c), generator=gen, device=dev).to(torch.bfloat16)
            y = se.se_excite(x, s)
            sums = se.se_grad_sums(gy, x)
            dx = se.se_grad_apply(gy, s, dm)
            torch.cuda.synchronize()
            terms = gy.double() * x.double()
            rel = float(((sums.double() - terms.sum((2, 3))).abs()
                         / terms.abs().sum((2, 3))).max())
            del terms
            if rel > 1e-5:
                fail(f"se {cell} {(n, c, h, w)}: the kernel's sums are {rel:.2e} off float64")
            if not torch.equal(y, x * s[:, :, None, None]):
                fail(f"se {cell} {(n, c, h, w)}: the product is not ATen's")
            err = _check_close(torch, dx, se.se_grad_apply_reference(gy, s, dm),
                               f"se {cell} {(n, c, h, w)} dx")
            out["max_abs_err"] = max(out["max_abs_err"], err)
            del y, sums, dx

            module = SEModule(c, max(1, round(c / 4))).to(dev)
            xg = x.detach().requires_grad_()

            def stock_forward():
                z = module.fc2(torch.relu(module.fc1(xg.mean(dim=(2, 3), keepdim=True))))
                return xg * torch.sigmoid(z)

            def stock():
                return torch.autograd.grad(stock_forward(), xg, gy)

            with torch.no_grad():
                if not torch.equal(module(x), stock_forward()):
                    fail(f"se {cell} {(n, c, h, w)}: SEModule's forward is not the stock ops'")

            kernels = {
                "excite": lambda: se.se_excite(x, s),
                "grad_sums": lambda: se.se_grad_sums(gy, x),
                "grad_apply": lambda: se.se_grad_apply(gy, s, dm),
            }
            nbytes = 2 * x.numel()
            row = {"shape": [n, c, h, w], "blocks": blocks, "kernels": {}}
            for k, fn in kernels.items():
                row["kernels"][k] = {"ms": _graph_ms(torch, fn),
                                     "bound_ms": SE_PASSES[k] * nbytes / PEAK_BYTES_PER_S * 1e3}
            row["ms"] = _graph_ms(torch, lambda: torch.autograd.grad(module(xg), xg, gy))
            row["plain_ms"] = _graph_ms(torch, stock)
            row["bound_ms"] = SE_ALL_PASSES * nbytes / PEAK_BYTES_PER_S * 1e3
            rows.append(row)
            log(f"[se] {cell} {(n, c, h, w)} x {blocks} blocks, device ms a call (graph of "
                f"{UP_CALLS}): " + "; ".join(
                    f"{k} {v['ms']:.4f} ({v['bound_ms'] / v['ms']:.0%} of {v['bound_ms']:.4f})"
                    for k, v in row["kernels"].items())
                + f"; SE forward and backward {row['ms']:.4f} against ATen's {row['plain_ms']:.4f}"
                f" ({row['plain_ms'] / row['ms']:.2f}x), bound {row['bound_ms']:.4f} "
                f"({row['bound_ms'] / row['ms']:.0%})")
            if row["ms"] >= row["plain_ms"]:
                fail(f"se {cell} {(n, c, h, w)}: the kernels' SE is no faster than ATen's")
            del x, gy, xg, module
            torch.cuda.empty_cache()
        total = {k: sum(r[k] * r["blocks"] for r in rows) for k in ("ms", "plain_ms", "bound_ms")}
        out["cells"][cell] = {"shapes": rows, **total}
        log(f"[se] {cell}, every block a micro-batch: the kernels' SE {total['ms']:.3f} ms, "
            f"ATen's {total['plain_ms']:.3f}, bound {total['bound_ms']:.3f} "
            f"({total['bound_ms'] / total['ms']:.0%})")
    out["ms"] = out["cells"]["SoccerNetBall_challenge2"]["ms"]
    out["plain_ms"] = out["cells"]["SoccerNetBall_challenge2"]["plain_ms"]
    return out


def se_launches():
    from tdeed_tpu_torch.kernels import se

    return [f.launches for f in (se.se_excite, se.se_grad_sums, se.se_grad_apply)]


def up_launches():
    from tdeed_tpu_torch.kernels import upsample

    return upsample.upsample_forward.launches, upsample.upsample_backward.launches


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


def _seed_gates(torch, model, seed):
    """Seeded nonzero weights and bias for every GSM gate conv (zero at
    init, where GSM only regroups channels and its gate would go untested),
    drawn on the CPU so every device gets the same values."""
    from tdeed_tpu_torch.models.shift import GSM

    gen = torch.Generator().manual_seed(seed + 9)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, GSM):
                for p in (m.conv3D.weight, m.conv3D.bias):
                    p.copy_(torch.randn(p.shape, generator=gen) * 0.05)


def _trainer(torch, cfg, device, crop, seed):
    from tdeed_tpu_torch.models.tdeed import build_model
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_train_step

    torch.manual_seed(seed)
    model = build_model(cfg, device=device)
    _seed_gates(torch, model, seed)
    opt, sched = make_optimizer(model.parameters(), cfg.learning_rate, 100, 10_000)
    step = make_train_step(
        model, opt, sched, crop_dim=crop, num_classes_bg=cfg.num_classes_bg,
        mixup=cfg.mixup, radi_displacement=cfg.radi_displacement, seed=seed,
    )
    return model, step


def agreement_phase(torch, **overrides):
    """fp32 train step and predict on the card vs the CPU, small input;
    ``overrides`` change FineDiving_small (phase 9: its GSM trunk)."""
    from tdeed_tpu_torch import load_config
    from tdeed_tpu_torch.train.step import make_predict_step

    cfg = load_config("FineDiving_small", config_root=CONFIGS, dtype="float32", **overrides)
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
    log(f"[agree] {cfg.feature_arch}: fp32 train step loss: cuda {loss_gpu:.7f} cpu {loss_cpu:.7f} "
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
    """A frame decoder (np.load unless another is given), with the seconds
    spent in it."""

    def __init__(self, fn=None):
        self.fn = fn
        self.seconds = 0.0

    def __call__(self, path):
        import numpy as np

        t0 = time.perf_counter()
        try:
            return (self.fn or np.load)(path)
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

    The frames are synthetic and decode-free: one FineDiving-layout video
    of SPOT_FRAMES random 256x256 uint8 frames from a seeded numpy
    generator, under a temporary directory in build/, each written with
    np.save at the path the FineDiving scheme resolves, and the
    predictor's decoder (the seam the JAX class also exposes as
    ``self.decoder``) is an np.load reader. The files sit in the page
    cache, so "decode" here is a memory read: the baseline phase 11d's
    spot() over JPEG files is set beside. (Phase 11a found Pillow and
    OpenCV on the card's machine but no libjpeg headers or system libjpeg;
    the native decoder builds there against the libjpeg Pillow bundles.)
    Each timed call starts with an empty decoded-frame cache, as a new
    video would. Returns {mode: (wall s, decode s)} of the device call.
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
        baseline = {}
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
            baseline[mode] = calls["device"][1:]  # (wall s, decode s)
            log(f"[spot] {mode} (batch {bs}, {2 if tta else 1} pass(es)), {SPOT_FRAMES} "
                f"frames of {FRAME}x{FRAME} uint8, {n_windows} windows: "
                + "; ".join(f"{k} {w * 1e3:.1f} ms ({SPOT_FRAMES / w:.0f} frames/s, "
                            f"decode {d / w:.1%} of wall)" for k, (_, w, d) in calls.items())
                + f"; {len(spotted)} events after SNMS; device == host bits, two calls "
                f"the same bits; {smi}")
            passes, n_batches = (2 if tta else 1), -(-n_windows // bs)
            x = torch.zeros((bs, cfg.clip_len, FRAME, FRAME, 3), dtype=torch.uint8,
                            device=pred.device)
            fwd_ms = _time_ms(torch, lambda: pred._scores([x], False), 5)
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
    return baseline


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


def acc_phase(torch, cfg, model, smi):
    """ACC_STEPS flagship steps at acc_grad_iter=2: batch 8 as 2
    micro-batches of 4, the kernel launched once per micro-batch."""
    from tdeed_tpu_torch.kernels.augment import photometric
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_train_step

    opt, sched = make_optimizer(model.parameters(), cfg.learning_rate, 100, 10_000)
    step = make_train_step(
        model, opt, sched, crop_dim=cfg.crop_dim, num_classes_bg=cfg.num_classes_bg,
        mixup=cfg.mixup, radi_displacement=cfg.radi_displacement, acc_grad_iter=2, seed=SEED,
    )
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    batch = _batch(torch, cfg.batch_size, cfg.clip_len, FRAME, cfg.num_classes_bg, gen, "cuda")
    times, losses = [], []
    for _ in range(ACC_STEPS):
        before = photometric.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(batch)["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if photometric.launches - before != 2:
            fail(f"an acc_grad_iter=2 step launched the photometric kernel "
                 f"{photometric.launches - before} times, not 2")
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite acc_grad_iter=2 loss: {losses}")
    log(f"[train] acc_grad_iter 2 (2 micro-batches of {cfg.batch_size // 2}): losses "
        f"{', '.join(f'{v:.4f}' for v in losses)}; step times "
        f"{', '.join(f'{t * 1e3:.1f}' for t in times)} ms; 2 kernel launches a step; {smi}")


def _write_cli_dataset(root, rng, write_video=_write_video):
    """CLI_VIDEOS FineDiving-layout videos of CLI_FRAMES frames, each
    written by ``write_video`` (np.save'd arrays by default), with an event
    of a random class every CLI_EVENT_EVERY frames; returns (frame_dir,
    data_root)."""
    import numpy as np

    frame_dir = os.path.join(root, "frames")
    data_root = os.path.join(root, "data")
    ds_dir = os.path.join(data_root, "finediving")
    os.makedirs(ds_dir)
    classes = [f"class{i}" for i in range(1, 5)]
    with open(os.path.join(ds_dir, "class.txt"), "w") as fp:
        fp.write("\n".join(classes) + "\n")
    vid = 0
    for split, count in CLI_VIDEOS:
        metas = []
        for _ in range(count):
            vid += 1
            name = f"{vid:02d}__01"
            write_video(frame_dir, name, CLI_FRAMES, rng)
            events = [{"frame": f, "label": classes[int(rng.integers(0, len(classes)))]}
                      for f in range(CLI_EVENT_EVERY // 2, CLI_FRAMES, CLI_EVENT_EVERY)]
            metas.append({"video": name, "num_frames": CLI_FRAMES, "fps": 25.0,
                          "events": events, "num_events": len(events)})
        with open(os.path.join(ds_dir, f"{split}.json"), "w") as fp:
            json.dump(metas, fp)
    return frame_dir, data_root


def _epoch_lines(cfg, stats, smi, tag="cli"):
    for e in stats["epochs"]:
        frames = cfg.batch_size * cfg.clip_len * e["steps"]
        log(f"[{tag}] epoch {e['epoch']}: {e['steps']} optimizer steps, train wall "
            f"{e['train_s'] * 1e3:.1f} ms, {frames / e['train_s']:.0f} train frames/s "
            f"including the loader, waiting for batches {e['wait_s'] * 1e3:.1f} ms "
            f"({e['wait_s'] / e['train_s']:.1%} of the train wall); val loss "
            f"{e['val_loss_s'] * 1e3:.1f} ms, val mAP {e['val_map_s'] * 1e3:.1f} ms, "
            f"checkpoint save {e['save_s'] * 1e3:.1f} ms; {smi}")


def _loader_alone(torch, cfg, load, smi, tag="cli"):
    """The training CLI's loader without the step: its stored train plan,
    sampler, frame cache and BatchLoader as cli/train.py builds them, over
    one epoch, with a cold frame cache and with one an epoch has filled,
    read on the host alone and through device_prefetch onto the card
    (pinning and copies). ``load`` is the decoder; a _TimedLoad also
    reports its own seconds."""
    from tdeed_tpu_torch.data.clips import load_plan
    from tdeed_tpu_torch.data.loader import BatchLoader, ClipSampler, FrameCache, device_prefetch
    from tdeed_tpu_torch.data.registry import get_spec

    plan = load_plan(cfg.store_dir, cfg.clip_len, cfg.radi_displacement, cfg.train_split)
    workers = max(4, cfg.num_workers)
    for how in ("host", "to the card"):
        parts = []
        for cached in ("cold", "warm"):
            cache = FrameCache(cfg.decode_cache_mb << 20)
            sampler = ClipSampler(plan, cfg.clip_len, get_spec(cfg.dataset).train_stride,
                                  cfg.radi_displacement, cfg.mixup, decoder=load, cache=cache)
            loader = BatchLoader(sampler, cfg.batch_size, cfg.dataset_len,
                                 num_workers=workers, seed=1)
            if cached == "warm":
                for _ in loader.epoch(0):  # fill the cache
                    pass
            hits, misses = cache.hits, cache.misses
            timed = isinstance(load, _TimedLoad)
            if timed:
                load.seconds = 0.0
            batches = loader.epoch(1)
            if how == "to the card":
                batches = device_prefetch(batches, "cuda", depth=2)
            t0 = time.perf_counter()
            n = sum(1 for _ in batches)
            torch.cuda.synchronize()
            t = (time.perf_counter() - t0) / n
            hit = (cache.hits - hits) / max(1, cache.hits - hits + cache.misses - misses)
            parts.append(f"{cached} cache {t * 1e3:.1f} ms a batch "
                         f"({cfg.batch_size * cfg.clip_len / t:.0f} frames/s; hits {hit:.1%}"
                         + (f"; np.load {load.seconds / n * 1e3:.1f} ms a batch over the "
                            "threads)" if timed else ")"))
        log(f"[{tag}] the loader alone, {how} (batch {cfg.batch_size} x clip {cfg.clip_len}, "
            f"mixup, {workers} threads): " + "; ".join(parts) + f"; {smi}")


def cli_phase(torch, smi):
    """The two CLIs in process on the card (see the module docstring).
    The CLIs look the decoder up through
    tdeed_tpu_torch.data.frames.get_decoder when they start, and it returns
    an np.load reader here: the decode-free baseline of phase 11c, which
    trains from JPEG files with the decoder the config names (phase 11a
    found no libjpeg headers or system libjpeg on the card's machine, and
    builds the native decoder against the libjpeg Pillow bundles there).
    Returns the first training run's stats."""
    import tempfile

    import numpy as np

    from tdeed_tpu_torch import load_config
    from tdeed_tpu_torch.cli import predict as predict_cli
    from tdeed_tpu_torch.cli import train as train_cli
    from tdeed_tpu_torch.data import frames as frame_io
    from tdeed_tpu_torch.kernels.augment import photometric

    load = _TimedLoad()
    get_decoder = frame_io.get_decoder
    frame_io.get_decoder = lambda kind="auto": load
    os.makedirs(REPO / "build", exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=REPO / "build") as root:
            t0 = time.perf_counter()
            frame_dir, data_root = _write_cli_dataset(root, np.random.default_rng(SEED + 5))
            log(f"[cli] dataset: {sum(n for _, n in CLI_VIDEOS)} videos of {CLI_FRAMES} "
                f"{FRAME}x{FRAME} frames written in {time.perf_counter() - t0:.1f} s")
            with open(os.path.join(CONFIGS, "FineDiving", "FineDiving_small.json")) as fp:
                raw = json.load(fp)
            raw.update(frame_dir=frame_dir, save_dir=os.path.join(root, "save"),
                       store_dir=os.path.join(root, "store"), **CLI_CONFIG)
            config_root = os.path.join(root, "configs")
            os.makedirs(os.path.join(config_root, "FineDiving"))

            def write_config(**kw):
                with open(os.path.join(config_root, "FineDiving", "FineDiving_small.json"),
                          "w") as fp:
                    json.dump(dict(raw, **kw), fp)

            argv = ["--model", "FineDiving_small", "--config_root", config_root,
                    "--data_root", data_root, "--no_wandb"]
            write_config(store_mode="store")
            try:
                train_cli.main(argv)
                fail("store mode did not exit")
            except SystemExit as e:
                if e.code not in (0, None):
                    fail(f"store mode exited with {e.code}")
            write_config(store_mode="load")
            cfg = load_config("FineDiving_small", config_root)
            k1_before = photometric.launches
            first = train_cli.main(argv)
            write_config(store_mode="load", num_epochs=CLI_RESUME_EPOCHS)
            resumed = train_cli.main(argv + ["--resume"])
            k1 = photometric.launches - k1_before
            steps_per_epoch = cfg.dataset_len // cfg.batch_size
            want_start = CLI_CONFIG["num_epochs"] * steps_per_epoch
            got = (resumed["start_epoch"], resumed["start_batch"], resumed["start_step"],
                   resumed["end_step"])
            if (first["start_step"], first["end_step"]) != (0, want_start) or got != (
                    CLI_CONFIG["num_epochs"], 0, want_start, CLI_RESUME_EPOCHS * steps_per_epoch):
                fail(f"the CLI ran steps {first['start_step']}-{first['end_step']}, then "
                     f"resumed at (epoch, batch, step) {got[:3]} and ended at step {got[3]}")
            steps = resumed["end_step"]
            if k1 < steps:
                fail(f"the CLI launched the photometric kernel {k1} times in {steps} steps")

            run_dir = cfg.save_dir
            files = sorted(os.listdir(run_dir))
            for name in ("checkpoint_best", "checkpoint_last", "train_meta.json", "loss.json",
                         "results_test.json"):
                if name not in files:
                    fail(f"the CLI did not write {name}: {files}")
            if not any(f.startswith("pred-test") for f in files):
                fail(f"the CLI did not write pred-test*: {files}")
            with open(os.path.join(run_dir, "train_meta.json")) as fp:
                history = json.load(fp)["history"]
            with open(os.path.join(run_dir, "results_test.json")) as fp:
                results = json.load(fp)
            if [r["epoch"] for r in history] != list(range(CLI_RESUME_EPOCHS)):
                fail(f"the history holds epochs {[r['epoch'] for r in history]}")
            losses = [r[k] for r in history for k in ("train", "val")]
            maps = [r["val_mAP"] for r in history if r["val_mAP"] is not None]
            maps += list(results.values())
            if not all(map(math.isfinite, losses)):
                fail(f"non-finite CLI loss: {losses}")
            if len(maps) < 2 or not all(math.isfinite(m) and 0.0 <= m <= 1.0 for m in maps):
                fail(f"CLI mAPs out of [0, 1]: {maps}")
            for stats in (first, resumed):
                _epoch_lines(cfg, stats, smi)
            cache = resumed["frame_cache"]
            log(f"[cli] losses {', '.join(f'{v:.4f}' for v in losses)}; val mAP "
                f"{[r['val_mAP'] for r in history]}; test {results}; {steps} optimizer steps, "
                f"{k1} photometric kernel launches; test evaluation {first['test_s'] * 1e3:.1f} "
                f"and {resumed['test_s'] * 1e3:.1f} ms; frame cache hit rate "
                f"{first['frame_cache']['hit_rate']:.1%} then {cache['hit_rate']:.1%} "
                f"({cache['entries']} frames held); np.load {load.seconds:.2f} s in all; {smi}")
            _loader_alone(torch, cfg, load, smi)

            split = os.path.join(data_root, "finediving", "test.json")
            with open(split) as fp:
                n_frames = {m["video"]: m["num_frames"] for m in json.load(fp)}
            outs = []
            for i in range(2):
                out = os.path.join(root, f"events{i}.json")
                t0 = time.perf_counter()
                predict_cli.main(["--model", "FineDiving_small", "--config_root", config_root,
                                  "--data_root", data_root, "--split", split, "--out", out])
                wall = time.perf_counter() - t0
                with open(out) as fp:
                    outs.append(json.load(fp))
                log(f"[cli] predict over the test split: {wall * 1e3:.1f} ms; {smi}")
            if outs[0] != outs[1]:
                fail("two predict runs wrote different events")
            events = [(p["video"], e) for p in outs[0] for e in p["events"]]
            if not events:
                fail("the predict CLI spotted no event")
            for video, e in events:
                if not (e["label"] in {f"class{i}" for i in range(1, 5)}
                        and 0 <= e["frame"] < n_frames[video] and 0.0 <= e["score"] <= 1.0):
                    fail(f"the predict CLI returned an invalid event {e}")
            log(f"[cli] predict: {len(events)} events, the same in both runs")
    finally:
        frame_io.get_decoder = get_decoder
    return first


def _write_frame(path, frame):
    import numpy as np

    with open(path, "wb") as fp:
        np.save(fp, frame)


def _link(src, dst):
    try:
        os.link(src, dst)
    except OSError:  # a file system without hard links
        shutil.copyfile(src, dst)


def _write_snb_dataset(root, rng):
    """Synthetic SoccerNet Ball and SoccerNet games at full frames, in the
    layouts the two datasets use, with their external label trees;
    returns (frame_dir, data_root, snb_labels_root, {split: [games]})."""
    import numpy as np

    from tdeed_tpu_torch.metrics.soccernet import SNB_GAMES

    h, w = SNB_FRAME
    frame_dir = os.path.join(root, "frames")
    data_root = os.path.join(root, "data")
    labels = {}
    for ds in ("soccernetball", "soccernet"):
        os.makedirs(os.path.join(data_root, ds))
        shutil.copyfile(REPO / "data" / ds / "class.txt",
                        os.path.join(data_root, ds, "class.txt"))
        labels[ds] = os.path.join(root, f"labels_{ds}")
        with open(os.path.join(data_root, ds, "labels_path.txt"), "w") as fp:
            fp.write(labels[ds])

    def classes(ds):
        with open(os.path.join(data_root, ds, "class.txt")) as fp:
            return [line.strip() for line in fp if line.strip()]

    def write_labels(ds, game, name, anns):
        os.makedirs(os.path.join(labels[ds], game), exist_ok=True)
        with open(os.path.join(labels[ds], game, name), "w") as fp:
            json.dump({"annotations": anns}, fp)

    def event(half, frame, label):
        ms = frame * 40  # 25 fps
        return {"gameTime": f"{half} - {ms // 60000:02d}:{ms // 1000 % 60:02d}",
                "label": label, "position": str(ms)}

    snb_classes = classes("soccernetball")
    games = {"train": SNB_GAMES["train"][:1], "val": SNB_GAMES["val"][:1],
             "test": SNB_GAMES["test"], "challenge": SNB_GAMES["challenge"][:1]}
    for split, names in games.items():
        for game in names:
            path = os.path.join(frame_dir, game)
            os.makedirs(path)
            for i in range(SNB_GAME_FRAMES):
                _write_frame(os.path.join(path, f"frame{i}.jpg"),
                             rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            if split != "challenge":
                write_labels("soccernetball", game, "Labels-ball.json", [
                    event(1, f, snb_classes[int(rng.integers(0, len(snb_classes)))])
                    for f in range(SNB_EVENT_EVERY // 2, SNB_GAME_FRAMES, SNB_EVENT_EVERY)])
        with open(os.path.join(data_root, "soccernetball", f"{split}.json"), "w") as fp:
            json.dump([{"video": g, "num_frames": SNB_GAME_FRAMES} for g in names], fp)

    sn_classes = classes("soccernet")
    pool = os.path.join(root, "sn_pool")
    os.makedirs(pool)
    for i in range(SN_POOL):
        _write_frame(os.path.join(pool, f"{i}.npy"),
                     rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    for split, game in (("train", "england_epl/2016-2017/synthetic train"),
                        ("val", "england_epl/2016-2017/synthetic val")):
        anns = []
        for half in (1, 2):
            path = os.path.join(frame_dir, game, f"half{half}")
            os.makedirs(path)
            for i in range(SN_HALF_FRAMES):
                _link(os.path.join(pool, f"{int(rng.integers(0, SN_POOL))}.npy"),
                      os.path.join(path, f"frame{i}.jpg"))
            anns += [event(half, f, sn_classes[int(rng.integers(0, len(sn_classes)))])
                     for f in range(SN_EVENT_EVERY // 2, SN_HALF_FRAMES, SN_EVENT_EVERY)]
        write_labels("soccernet", game, "Labels-v2.json", anns)
        with open(os.path.join(data_root, "soccernet", f"{split}.json"), "w") as fp:
            json.dump([{"video": f"{game}/half{h_}", "num_frames": SN_HALF_FRAMES}
                       for h_ in (1, 2)], fp)
    return frame_dir, data_root, labels["soccernetball"], games


def _snb_batch(torch, cfg, two_heads):
    """A joint batch on the card (one SoccerNet Ball clip, one SoccerNet
    clip, each with its mixup partner) of full uint8 frames, from a seed."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    b, t, (h, w) = cfg.batch_size, cfg.clip_len, SNB_FRAME

    def frames():
        return torch.randint(0, 256, (b, t, h, w, 3), generator=gen, device="cuda",
                             dtype=torch.uint8)

    def labels():
        return torch.randint(0, min(two_heads), (b, t), generator=gen, device="cuda")

    def displ():
        r = cfg.radi_displacement
        return torch.randint(-r, r + 1, (b, t), generator=gen, device="cuda").float()

    return {"frame": frames(), "label": labels(), "labelD": displ(), "frame2": frames(),
            "label2": labels(), "labelD2": displ(),
            "dataset": torch.tensor([1, 2] * (b // 2), device="cuda")}


def _snb_step_alone(torch, cfg, smi):
    """The phase-8 training step with its batch already on the card: a
    joint batch (one SoccerNet Ball clip, one SoccerNet clip) of full
    uint8 frames, the step built as the training CLI builds it."""
    from tdeed_tpu_torch.models.tdeed import build_model, two_heads_for
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_train_step

    torch.manual_seed(SEED)
    two_heads = two_heads_for(cfg)
    model = build_model(cfg, two_heads, device="cuda")
    opt, sched = make_optimizer(model.parameters(), cfg.learning_rate, 3, 30)
    step = make_train_step(
        model, opt, sched, crop_dim=cfg.crop_dim, num_classes_bg=cfg.num_classes_bg,
        mixup=cfg.mixup, radi_displacement=cfg.radi_displacement,
        acc_grad_iter=cfg.acc_grad_iter, seed=SEED,
    )
    batch = _snb_batch(torch, cfg, two_heads)
    b, t, (h, w) = cfg.batch_size, cfg.clip_len, SNB_FRAME
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for _ in range(SNB_ALONE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(batch)["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite SoccerNet Ball step loss: {losses}")
    n = b * t
    log(f"[snb] the step alone (batch {b} x clip {t} of {h}x{w} uint8 on the card, mixup, "
        f"{cfg.dtype}, {cfg.feature_arch}, two heads {two_heads}): losses "
        f"{', '.join(f'{v:.4f}' for v in losses)}; step times "
        f"{', '.join(f'{x * 1e3:.1f}' for x in times)} ms; after the first "
        f"{n * (len(times) - 1) / sum(times[1:]):.0f} frames/s; peak memory {peak:.2f} GiB; "
        f"{sum(p.numel() for p in model.parameters())} params; {smi}")
    return {"step_ms": [x * 1e3 for x in times], "peak_gib": peak}


def snb_phase(torch, smi):
    """Phase 8 (see the module docstring). Returns the photometric
    kernel's entries for phase 8: its launches on the path, and the check
    and times of one step's launch at the step's shape."""
    import tempfile

    import numpy as np

    from tdeed_tpu_torch import load_config
    from tdeed_tpu_torch.cli import evaluate_challenge
    from tdeed_tpu_torch.cli import train as train_cli
    from tdeed_tpu_torch.data import frames as frame_io
    from tdeed_tpu_torch.kernels.augment import photometric, photometric_reference
    from tdeed_tpu_torch.metrics import soccernet
    from tdeed_tpu_torch.models.tdeed import two_heads_for
    from tdeed_tpu_torch.train import step as step_mod

    load = _TimedLoad()
    get_decoder = frame_io.get_decoder
    frame_io.get_decoder = lambda kind="auto": load
    preprocess = step_mod.train_preprocess
    seen = {}

    def capture(frames, params, *into):
        out = preprocess(frames, params, *into)  # into: the trunk graph's input, if any
        if "frames" not in seen:  # the first micro-batch of the run
            seen.update(frames=frames.to(torch.bfloat16).clone(), params=params.clone(),
                        out=out.clone())
        return out

    step_mod.train_preprocess = capture
    os.makedirs(REPO / "build", exist_ok=True)
    try:
        with tempfile.TemporaryDirectory(dir=REPO / "build") as root:
            t0 = time.perf_counter()
            frame_dir, data_root, labels_root, games = _write_snb_dataset(
                root, np.random.default_rng(SEED + 7))
            log(f"[snb] dataset: SoccerNet Ball {sum(map(len, games.values()))} games of "
                f"{SNB_GAME_FRAMES} {SNB_FRAME[0]}x{SNB_FRAME[1]} frames, SoccerNet 2 games of "
                f"2 halves of {SN_HALF_FRAMES} frames ({SN_POOL} distinct), written in "
                f"{time.perf_counter() - t0:.1f} s")
            with open(os.path.join(CONFIGS, "SoccerNetBall",
                                   "SoccerNetBall_challenge2.json")) as fp:
                raw = json.load(fp)
            raw.update(frame_dir=frame_dir, save_dir=os.path.join(root, "save"),
                       store_dir=os.path.join(root, "store"), **SNB_CONFIG)
            raw["pretrain"].update(frame_dir=frame_dir, store_dir=os.path.join(root, "store2"))
            config_root = os.path.join(root, "configs")
            os.makedirs(os.path.join(config_root, "SoccerNetBall"))
            name = "SoccerNetBall_challenge2"

            def write_config(**kw):
                with open(os.path.join(config_root, "SoccerNetBall", f"{name}.json"),
                          "w") as fp:
                    json.dump(dict(raw, **kw), fp)

            argv = ["--model", name, "--config_root", config_root, "--data_root", data_root]
            write_config(store_mode="store")
            try:
                train_cli.main(argv + ["--no_wandb"])
                fail("store mode did not exit")
            except SystemExit as e:
                if e.code not in (0, None):
                    fail(f"store mode exited with {e.code}")
            write_config(store_mode="load")
            cfg = load_config(name, config_root)
            photometric.launches = 0
            torch.cuda.reset_peak_memory_stats()
            stats = train_cli.main(argv + ["--no_wandb"])
            t0 = time.perf_counter()
            challenge = evaluate_challenge.main(argv)
            challenge_s = time.perf_counter() - t0
            launches = photometric.launches
            peak = torch.cuda.max_memory_allocated() / 2**30

            steps = stats["end_step"]
            want_steps = SNB_CONFIG["num_epochs"] * (cfg.dataset_len // cfg.batch_size)
            if steps != want_steps:
                fail(f"the SoccerNet Ball run took {steps} optimizer steps, not {want_steps}")
            if launches != steps * cfg.acc_grad_iter:
                fail(f"phase 8 launched the photometric kernel {launches} times in "
                     f"{steps} steps of {cfg.acc_grad_iter} micro-batch(es)")
            run_dir = cfg.save_dir
            for f in ("checkpoint_best", "checkpoint_last", "loss.json"):
                if not os.path.exists(os.path.join(run_dir, f)):
                    fail(f"the SoccerNet Ball run did not write {f}")
            with open(os.path.join(run_dir, "loss.json")) as fp:
                history = json.load(fp)
            losses = [r[k] for r in history for k in ("train", "val")]
            val_maps = [r["val_mAP"] for r in history if r["val_mAP"] is not None]
            snb = stats["soccernet"]["test"]
            maps = val_maps + [snb["a_mAP"]]
            if not all(map(math.isfinite, losses)):
                fail(f"non-finite SoccerNet Ball loss: {losses}")
            if len(val_maps) != 1 or not all(math.isfinite(m) and 0.0 < m <= 1.0 for m in maps):
                fail(f"SoccerNet Ball mAPs not in (0, 1]: val {val_maps}, test {snb['a_mAP']}")
            preds_root = os.path.join(run_dir, "preds")
            t0 = time.perf_counter()
            again = soccernet.evaluate_snb(labels_root, preds_root, "test")
            snb_s = time.perf_counter() - t0
            if again["a_mAP"] != snb["a_mAP"]:
                fail("evaluate_snb gave two results on the same predictions")
            names = set(soccernet.SNB_EVENTS)
            for game in games["challenge"]:
                path = os.path.join(challenge["preds_root"], game, "results_spotting.json")
                if not os.path.exists(path):
                    fail(f"the challenge CLI did not write {path}")
                with open(path) as fp:
                    preds = json.load(fp)["predictions"]
                if not preds:
                    fail("the challenge CLI spotted no event")
                for p in preds:
                    if not (p["label"] in names and p["half"] == 1
                            and 0 <= p["position"] < SNB_GAME_FRAMES * 40
                            and 0.0 <= p["confidence"] <= 1.0):
                        fail(f"the challenge CLI wrote an invalid prediction {p}")
            _epoch_lines(cfg, stats, smi, "snb")
            log(f"[snb] {cfg.feature_arch}, two heads {two_heads_for(cfg)}, batch "
                f"{cfg.batch_size} x clip "
                f"{cfg.clip_len} of {SNB_FRAME[0]}x{SNB_FRAME[1]}: losses "
                f"{', '.join(f'{v:.4f}' for v in losses)}; val mAP {val_maps}; test "
                f"(evaluate, SNMS) {stats['test_s'] * 1e3:.1f} ms with evaluate_snb a-mAP@1 "
                f"{snb['a_mAP']:.4f}, evaluate_snb alone {snb_s * 1e3:.1f} ms; challenge CLI "
                f"{challenge_s * 1e3:.1f} ms ({challenge['seconds'] * 1e3:.1f} ms of inference "
                f"and writes), {len(preds)} predictions; {steps} optimizer steps, {launches} "
                f"photometric kernel launches; peak memory over the run {peak:.2f} GiB; "
                f"frame cache hit rate {stats['frame_cache']['hit_rate']:.1%}; "
                f"np.load {load.seconds:.2f} s in all; {smi}")
    finally:
        frame_io.get_decoder = get_decoder
        step_mod.train_preprocess = preprocess

    frames, params, got = seen["frames"], seen["params"], seen["out"]
    shape = tuple(frames.shape)
    err = _check_close(torch, got, photometric_reference(frames, params),
                       f"bf16 {shape}, the first phase-8 step's launch", BF16_ULP_AT_2)
    ms = _time_ms(torch, lambda: photometric(frames, params), 20)
    plain_ms = _time_ms(torch, lambda: photometric_reference(frames, params), 3)
    bound_ms, bound_by = _k1_bound(params, 2 * frames.numel() * 2, shape)
    log(f"[snb] photometric kernel at the step's {shape} bf16: {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.0%} of it")
    del seen, frames, params, got
    torch.cuda.empty_cache()
    alone = _snb_step_alone(torch, cfg, smi)
    return {"launches": launches, "step_shape": list(shape), "step_max_abs_err": err,
            "step_ms": ms, "step_plain_ms": plain_ms, "step_bound_ms": bound_ms,
            "step_bound_by": bound_by, "train_step_ms": alone["step_ms"],
            "train_peak_gib": alone["peak_gib"]}


def _timm_file(torch, trunk, path, seed):
    """Write a timm-layout RegNet-Y state dict for ``trunk`` (timm's keys:
    a shifted block's ``conv1.net.*`` under ``conv1.*``, no ``gs``; BN
    counters; a classifier head) to ``path``: the trunk's own values moved
    by seeded noise, so each tensor differs from the model's."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in trunk.state_dict().items():
        if ".gs." in k:
            continue
        k = k.replace(".conv1.net.", ".conv1.")
        v = v.detach().cpu()
        if v.is_floating_point():
            v = v + 0.01 * torch.randn(v.shape, generator=gen)
            if k.endswith("running_var"):
                v = v.abs()
        sd[k] = v
    sd["head.fc.weight"] = torch.zeros(1000, trunk.feat_dim)
    sd["head.fc.bias"] = torch.zeros(1000)
    torch.save(sd, path)
    return sd


def trunks_phase(torch, smi):
    """Phase 9a: FineDiving_small at full width with each PHASE9_ARCHS
    trunk: a timm-layout file through load_backbone (every written trunk
    tensor equal to the file's), PHASE9_STEPS train steps with the batch on
    the card, and one predict request of host uint8."""
    import tempfile

    from tdeed_tpu_torch import load_config
    from tdeed_tpu_torch.checkpoint import load_backbone
    from tdeed_tpu_torch.kernels.augment import photometric
    from tdeed_tpu_torch.train.step import make_predict_step

    os.makedirs(REPO / "build", exist_ok=True)
    for arch in PHASE9_ARCHS:
        cfg = load_config("FineDiving_small", config_root=CONFIGS, feature_arch=arch)
        model, step = _trainer(torch, cfg, "cuda", cfg.crop_dim, SEED)
        with tempfile.TemporaryDirectory(dir=REPO / "build") as root:
            sd = _timm_file(torch, model._features, os.path.join(root, "regnety.pth"), SEED + 10)
            written = load_backbone(model, os.path.join(root, "regnety.pth"))
        trunk = model._features.state_dict()
        equal = all(torch.equal(trunk[k].cpu(), sd[src].to(trunk[k].dtype))
                    for k, src in written.items())
        n_file = sum(1 for k in sd if not k.startswith("head.")
                     and not k.endswith("num_batches_tracked"))
        if not equal or len(written) != n_file:
            fail(f"{arch}: load_backbone wrote {len(written)} of the file's {n_file} trunk "
                 f"tensors, equal to the file: {equal}")
        gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
        batch = _batch(torch, cfg.batch_size, cfg.clip_len, FRAME, cfg.num_classes_bg,
                       gen, "cuda")
        before = photometric.launches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for _ in range(PHASE9_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(batch)["loss"]))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if photometric.launches - before != PHASE9_STEPS:
            fail(f"{arch}: {PHASE9_STEPS} steps launched the photometric kernel "
                 f"{photometric.launches - before} times")
        if not all(map(math.isfinite, losses)):
            fail(f"{arch}: non-finite training loss {losses}")
        predict = make_predict_step(model, crop_dim=cfg.crop_dim,
                                    radi_displacement=cfg.radi_displacement)
        frames = torch.randint(0, 256, (REQUEST_CLIPS, cfg.clip_len, FRAME, FRAME, 3),
                               generator=torch.Generator().manual_seed(SEED + 12),
                               dtype=torch.uint8)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cls, probs = predict(frames)
        torch.cuda.synchronize()
        predict_ms = (time.perf_counter() - t0) * 1e3
        if tuple(probs.shape) != (REQUEST_CLIPS, cfg.clip_len, cfg.num_classes_bg) or not bool(
                (torch.isfinite(probs) & (probs >= 0) & (probs <= 1)).all()):
            fail(f"{arch}: predict returned {tuple(probs.shape)} scores, or some outside [0, 1]")
        n = cfg.batch_size * cfg.clip_len
        log(f"[trunks] {arch} (batch {cfg.batch_size} x clip {cfg.clip_len}, {FRAME}^2 uint8 "
            f"-> crop {cfg.crop_dim}, mixup, {cfg.dtype}): load_backbone wrote {len(written)} "
            f"trunk tensors, each equal to the file's; losses "
            f"{', '.join(f'{v:.4f}' for v in losses)}; step times "
            f"{', '.join(f'{x * 1e3:.1f}' for x in times)} ms, after the first "
            f"{n * (len(times) - 1) / sum(times[1:]):.0f} frames/s; peak memory {peak:.2f} GiB; "
            f"{sum(p.numel() for p in model.parameters())} params; a {REQUEST_CLIPS}-clip predict "
            f"request of host uint8 {predict_ms:.1f} ms; {smi}")
        del model, step, batch, predict
        torch.cuda.empty_cache()


def checkpoint_phase(torch, smi):
    """Phase 9b: PHASE9_STEPS SoccerNetBall_challenge2 steps at full frames
    with checkpoint_backbone off and as many with it on, from the same
    weights, batch and draws. The first step of each is held to the same
    loss (1e-3 relative), the same running statistics and BN counters;
    the peak over the steps is lower with it on; the step time is that of
    the steps after the first (the first allocates AdamW's state and picks
    the cuDNN algorithms)."""
    import dataclasses
    import statistics

    from tdeed_tpu_torch import load_config
    from tdeed_tpu_torch.models.tdeed import build_model, two_heads_for
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_train_step

    cfg = load_config("SoccerNetBall_challenge2", config_root=CONFIGS)
    two_heads = two_heads_for(cfg)
    batch = _snb_batch(torch, cfg, two_heads)
    torch.manual_seed(SEED)
    start = None
    runs = {}
    for ck in (False, True):
        model = build_model(dataclasses.replace(cfg, checkpoint_backbone=ck), two_heads,
                            device="cuda")
        if start is None:
            start = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(start)
        opt, sched = make_optimizer(model.parameters(), cfg.learning_rate, 3, 30)
        step = make_train_step(
            model, opt, sched, crop_dim=cfg.crop_dim, num_classes_bg=cfg.num_classes_bg,
            mixup=cfg.mixup, radi_displacement=cfg.radi_displacement, seed=SEED,
        )
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, times, stats = [], [], None
        for _ in range(PHASE9_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step(batch)["loss"]))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if stats is None:
                stats = {k: v.clone() for k, v in model.state_dict().items()
                         if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[ck] = (losses, times, peak, stats)
        del model, opt, sched, step
        torch.cuda.empty_cache()
    (l0, t0_, p0, s0), (l1, t1_, p1, s1) = runs[False], runs[True]
    rel = abs(l1[0] - l0[0]) / abs(l0[0])
    same_stats = all(torch.equal(s0[k], s1[k]) for k in s0)
    counters = {int(v) for k, v in s1.items() if k.endswith("num_batches_tracked")}
    ms0, ms1 = statistics.median(t0_[1:]), statistics.median(t1_[1:])

    def each(xs, fmt):
        return ", ".join(format(x, fmt) for x in xs)

    log(f"[ckpt] {cfg.feature_arch}, batch {cfg.batch_size} x clip {cfg.clip_len} of "
        f"{SNB_FRAME[0]}x{SNB_FRAME[1]}, {cfg.dtype}, two heads {two_heads}, "
        f"{PHASE9_STEPS} steps each: checkpoint_backbone off: losses {each(l0, '.6f')}, "
        f"steps {each(t0_, '.1f')} ms, median after the first {ms0:.1f} ms, peak "
        f"{p0:.2f} GiB; on: losses {each(l1, '.6f')} (first step rel {rel:.2e}), steps "
        f"{each(t1_, '.1f')} ms, median after the first {ms1:.1f} ms ({ms1 / ms0:.1%} of "
        f"off), peak {p1:.2f} GiB ({p1 / p0:.1%} of off); after the first step running "
        f"statistics equal: {same_stats}, BN counters {sorted(counters)}; {smi}")
    if not all(map(math.isfinite, l0 + l1)):
        fail(f"non-finite loss with checkpoint_backbone off {l0} or on {l1}")
    if not rel <= 1e-3:
        fail("checkpoint_backbone changed the step's loss")
    if not same_stats or counters != {1}:
        fail("checkpoint_backbone changed the running statistics or the BN counters")
    if not p1 < p0:
        fail("checkpoint_backbone did not lower the step's peak memory")


def export_phase(torch, smi):
    """Phase 9c: FineDiving_small at full width exported on the card
    (EXPORT_CLIPS clips, both passes, stored frames of FRAME^2), loaded by
    a fresh ExportedPredictor and held against the eager predict step on
    the same host uint8 batch."""
    import statistics
    import tempfile

    from tdeed_tpu_torch import load_config
    from tdeed_tpu_torch.infer.export import ExportedPredictor, export_predictor
    from tdeed_tpu_torch.models.tdeed import build_model
    from tdeed_tpu_torch.train.step import make_predict_step

    cfg = load_config("FineDiving_small", config_root=CONFIGS)
    torch.manual_seed(SEED)
    model = build_model(cfg, device="cuda")
    classes = {f"class{i}": i for i in range(1, cfg.num_classes + 1)}
    frames = torch.randint(0, 256, (EXPORT_CLIPS, cfg.clip_len, FRAME, FRAME, 3),
                           generator=torch.Generator().manual_seed(SEED + 13), dtype=torch.uint8)
    predict = make_predict_step(model, crop_dim=cfg.crop_dim,
                                radi_displacement=cfg.radi_displacement)

    def median_ms(fn):
        times = []
        for _ in range(EXPORT_CALLS + 1):  # the first pays first-call costs
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])

    os.makedirs(REPO / "build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as root:
        out = os.path.join(root, "artifact")
        t0 = time.perf_counter()
        export_predictor(cfg, model.state_dict(), classes, out, batch_size=EXPORT_CLIPS,
                         frame_hw=(FRAME, FRAME), device="cuda")
        export_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out))
        t0 = time.perf_counter()
        ep = ExportedPredictor(out)
        load_s = time.perf_counter() - t0
    errs, same_cls = [], []
    for hflip in (False, True):
        cls, probs = ep(frames, hflip=hflip)
        want_cls, want = predict(frames, hflip)
        if tuple(probs.shape) != tuple(want.shape):
            fail(f"the exported program returned {tuple(probs.shape)}, the eager step "
                 f"{tuple(want.shape)}")
        errs.append(float((probs.float() - want.float()).abs().max()))
        same_cls.append(float((cls == want_cls).float().mean()))
    eager_ms = median_ms(lambda: predict(frames))
    exported_ms = median_ms(lambda: ep(frames))
    log(f"[export] FineDiving_small ({cfg.feature_arch}, {cfg.dtype}) exported on the card for "
        f"{EXPORT_CLIPS} clips of {cfg.clip_len} x {FRAME}^2 uint8, both passes: export "
        f"{export_s:.1f} s, artifact {size} bytes, load {load_s:.1f} s; probs max abs diff "
        f"against the eager step {errs[0]:.3g} (hflip {errs[1]:.3g}), argmax agreement "
        f"{same_cls[0]:.2%} / {same_cls[1]:.2%}; median of {EXPORT_CALLS} calls of host uint8: "
        f"eager {eager_ms:.2f} ms, exported {exported_ms:.2f} ms; {smi}")
    if not max(errs) <= 1e-3:
        fail("the exported predict step disagrees with the eager one")
    del model, ep, predict
    torch.cuda.empty_cache()


def _dp_configs():
    """Phase 10a's two settings: the flagship at full width (bf16), and an
    fp32 one cut to DP_FP32 (the DP arithmetic held tightly)."""
    from tdeed_tpu_torch import load_config

    flagship = load_config("FineDiving_small", config_root=CONFIGS)
    b, hw, crop = DP_FP32
    fp32 = load_config("FineDiving_small", config_root=CONFIGS, dtype="float32",
                       batch_size=b, crop_dim=crop)
    return {"bf16": (flagship, FRAME), "fp32": (fp32, hw)}


def _dp_global_batch(torch, cfg, hw):
    """The global batch from a seeded CPU generator: every process makes
    the same one and keeps its rows."""
    return _batch(torch, cfg.batch_size, cfg.clip_len, hw, cfg.num_classes_bg,
                  torch.Generator().manual_seed(SEED + 21), "cpu")


def _dp_steps(torch, cfg, device, batch, distributed, steps, perm=None):
    """``steps`` train steps (seeded weights and draws) on ``batch``: the
    losses, each step's host time, the photometric launches, and after
    step 0 the averaged gradients and the model's state on the host.
    ``perm`` reorders the batch's rows and their draws alike: the same
    step, with its sums over the batch in another order."""
    from tdeed_tpu_torch.kernels.augment import photometric
    from tdeed_tpu_torch.models.tdeed import build_model
    from tdeed_tpu_torch.parallel import mesh
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import StepDraws, make_train_step

    torch.manual_seed(SEED)
    model = build_model(cfg, device=device)
    if distributed:
        mesh.distribute(model)
    opt, sched = make_optimizer(model.parameters(), cfg.learning_rate, 100, 10_000)
    step = make_train_step(
        model, opt, sched, crop_dim=cfg.crop_dim, num_classes_bg=cfg.num_classes_bg,
        mixup=cfg.mixup, radi_displacement=cfg.radi_displacement, seed=SEED,
    )
    batch = {k: v.to(device) for k, v in batch.items()}
    if perm is not None:
        batch = {k: v[perm] for k, v in batch.items()}
    out = {"losses": [], "times": []}
    launches = photometric.launches
    for i in range(steps):
        draws = step.draw(batch)
        if perm is not None:
            draws = [StepDraws(d.crop, d.lam[perm], d.aug[perm],
                               {k: m[perm] for k, m in d.dropout_keep.items()}) for d in draws]
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out["losses"].append(float(step(batch, draws)["loss"]))
        torch.cuda.synchronize(device)
        out["times"].append(time.perf_counter() - t0)
        if i == 0:  # copies: on the CPU .cpu() would alias what the next step updates
            out["grads"] = {n: p.grad.detach().to("cpu", torch.float32, copy=True)
                            for n, p in model.named_parameters()}
            out["state"] = {k: v.detach().to("cpu", copy=True)
                            for k, v in model.state_dict().items()}
    out["launches"] = photometric.launches - launches
    return out


def _dp_rank(rank, world, port, backend, root):
    """Phase 10a's rank: joins the group, runs each setting's steps on its
    rows of the global batch and saves what _dp_steps returns."""
    import torch

    from tdeed_tpu_torch.parallel import mesh

    # the parent's math (device_phase): a spawned process starts with
    # cuDNN's TF32 on, which would run the fp32 convs at 10 mantissa bits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = mesh.init_distributed(f"cuda:{rank if backend == 'nccl' else 0}", rank, world,
                                   f"tcp://localhost:{port}", backend=backend)
    try:
        out = {}
        for name, (cfg, hw) in _dp_configs().items():
            rows = mesh.global_rows(cfg.batch_size, 1, rank, world)
            batch = {k: v[rows] for k, v in _dp_global_batch(torch, cfg, hw).items()}
            out[name] = _dp_steps(torch, cfg, device, batch, True,
                                  DP_STEPS if name == "bf16" else 1)
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()


def _dp_halves_floor(torch, cfg, hw, device):
    """The largest difference of the eval-mode predict step's scores on the
    global batch from its scores on the batch's two halves, each half in
    its own call: rows are independent in eval, so this is how far a
    batch of half the size moves the convolutions' results (cuDNN may
    pick other algorithms for another batch)."""
    from tdeed_tpu_torch.models.tdeed import build_model
    from tdeed_tpu_torch.train.step import make_predict_step

    torch.manual_seed(SEED)
    predict = make_predict_step(build_model(cfg, device=device), crop_dim=cfg.crop_dim,
                                radi_displacement=cfg.radi_displacement)
    frames = _dp_global_batch(torch, cfg, hw)["frame"].to(device)
    half = cfg.batch_size // 2
    whole = predict(frames)[1]
    parts = torch.cat([predict(frames[:half])[1], predict(frames[half:])[1]])
    return float((whole - parts).abs().max())


def _dp_distance(torch, got, want, lr0):
    """(loss rel, running statistics' max err relative to max(1, |b|),
    gradient relative L2, share of weights within a quarter of Adam's first
    step, the 3 leaves with most of the gradient difference, BN counters
    equal) of two _dp_steps results at step 0."""
    loss_rel = abs(got["losses"][0] - want["losses"][0]) / abs(want["losses"][0])
    stats = max(float(((got["state"][k].double() - v.double()).abs()
                       / v.double().abs().clamp_min(1.0)).max())
                for k, v in want["state"].items() if "running" in k)
    sq = {k: float((got["grads"][k].double() - v.double()).square().sum())
          for k, v in want["grads"].items()}
    den = sum(float(v.double().square().sum()) for v in want["grads"].values())
    top = sorted(sq, key=sq.get, reverse=True)[:3]
    close = total = 0
    for k, v in want["state"].items():
        if v.is_floating_point() and "running" not in k:
            close += int(((got["state"][k].double() - v.double()).abs() <= 0.25 * lr0).sum())
            total += v.numel()
    counters = all(torch.equal(got["state"][k], v) for k, v in want["state"].items()
                   if not v.is_floating_point())
    return (loss_rel, stats, math.sqrt(sum(sq.values()) / den), close / total,
            ", ".join(f"{k} {sq[k] / max(sum(sq.values()), 1e-300):.0%}" for k in top),
            counters)


def dp_steps_phase(torch, smi):
    """Phase 10a: the flagship step over DP_RANKS ranks against the one
    process step on the global batch, and an fp32 step cut to DP_FP32 the
    same way; returns the ranks' photometric launches."""
    import tempfile

    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    from tdeed_tpu_torch.parallel import mesh

    configs = _dp_configs()
    dev = torch.device("cuda", 0)
    one, floors, halves = {}, {}, {}
    for name, (cfg, hw) in configs.items():
        halves[name] = _dp_halves_floor(torch, cfg, hw, dev)
        batch = _dp_global_batch(torch, cfg, hw)
        one[name] = _dp_steps(torch, cfg, dev, batch, False, DP_STEPS if name == "bf16" else 1)
        # the noise of this step: the same step again, and on the batch's
        # halves interleaved (clip i of each half side by side), which
        # changes every partial sum of its reductions, as the ranks' split
        # does (swapping the halves would only swap two subtrees)
        half = cfg.batch_size // 2
        perm = [i + h for i in range(half) for h in (0, half)]
        floors[name] = [_dp_steps(torch, cfg, dev, batch, False, 1),
                        _dp_steps(torch, cfg, dev, batch, False, 1, perm)]
    torch.cuda.empty_cache()
    backend = "nccl" if torch.cuda.device_count() >= DP_RANKS else "gloo"
    where = ("cuda:0 and cuda:1" if backend == "nccl"
             else f"cuda:0 for both ({torch.cuda.device_count()} card)")
    os.makedirs(REPO / "build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as root:
        t0 = time.perf_counter()
        procs = mp.start_processes(_dp_rank, args=(DP_RANKS, mesh.free_port(), backend, root),
                                   nprocs=DP_RANKS, join=False, start_method="spawn")
        try:
            while not procs.join(timeout=1.0):
                if time.perf_counter() - t0 > DP_TIMEOUT_S:
                    fail(f"the {DP_RANKS} ranks did not finish in {DP_TIMEOUT_S} s")
        except ProcessException as e:
            fail(f"a data-parallel rank failed: {e}")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
        wall = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(root, f"rank{r}.pt")) for r in range(DP_RANKS)]

    for name in configs:
        outs = [r[name] for r in ranks]
        if not all(math.isfinite(v) for o in outs for v in o["losses"]):
            fail(f"non-finite data-parallel loss ({name}): {[o['losses'] for o in outs]}")
        if any(o["losses"] != outs[0]["losses"] for o in outs):
            fail(f"the ranks report different global losses ({name})")
        for k, v in outs[0]["state"].items():
            if not torch.equal(v, outs[1]["state"][k]):
                fail(f"the ranks hold different {k} after a step ({name})")
    if any((r["bf16"]["launches"], r["fp32"]["launches"]) != (DP_STEPS, 1) for r in ranks):
        fail(f"the ranks launched the photometric kernel "
             f"{[(r['bf16']['launches'], r['fp32']['launches']) for r in ranks]} times in "
             f"({DP_STEPS}, 1) steps")
    cfg = configs["bf16"][0]
    lr0 = cfg.learning_rate * 0.01
    ms = lambda ts: ", ".join(f"{t * 1e3:.1f}" for t in ts)  # noqa: E731
    log(f"[dp] 10a: FineDiving_small ({cfg.feature_arch}, {cfg.dtype}, mixup) batch "
        f"{cfg.batch_size} x clip {cfg.clip_len}, {FRAME}^2 uint8 -> crop {cfg.crop_dim}, over "
        f"{DP_RANKS} ranks ({backend} on {where}), {cfg.batch_size // DP_RANKS} clips a rank; "
        f"step times (ms) rank 0: {ms(ranks[0]['bf16']['times'])}; rank 1: "
        f"{ms(ranks[1]['bf16']['times'])}; one process on the global batch: "
        f"{ms(one['bf16']['times'])}; the ranks' processes {wall:.1f} s from spawn to exit, "
        f"the fp32 step included; {DP_STEPS} photometric launches on each rank; {smi}")
    ok = True
    for name, (c, hw) in configs.items():
        got = _dp_distance(torch, ranks[0][name], one[name], lr0)
        again, mixed = (_dp_distance(torch, f, one[name], lr0) for f in floors[name])
        log(f"[dp] 10a {name} (batch {c.batch_size} x clip {c.clip_len}, {hw}^2 -> crop "
            f"{c.crop_dim}), step 0 over {DP_RANKS} ranks against one process: loss rel "
            f"{got[0]:.3g}, running statistics {got[1]:.3g}, gradients {got[2]:.3g} relative L2 "
            f"(most in {got[4]}), weights within a quarter of Adam's first step {got[3]:.4%}, "
            f"BN counters equal {got[5]}; the one-process step run again: {again[0]:.3g}, "
            f"{again[1]:.3g}, {again[2]:.3g}, {again[3]:.4%}; on its halves interleaved: "
            f"{mixed[0]:.3g}, {mixed[1]:.3g}, {mixed[2]:.3g} (most in {mixed[4]}), "
            f"{mixed[3]:.4%}; the eval scores of the batch's halves in two calls against "
            f"one call: max abs diff {halves[name]:.3g}; losses over ranks {', '.join(f'{v:.4f}' for v in ranks[0][name]['losses'])}, "
            f"one process {', '.join(f'{v:.4f}' for v in one[name]['losses'])}; {smi}")
        bounds = DP_BOUNDS[name]
        grads = max(bounds["grads"], DP_FLOOR_RATIO * max(again[2], mixed[2]))
        ok &= (got[0] <= bounds["loss"] and got[1] <= bounds["stats"]
               and got[2] <= grads and got[3] >= bounds["weights"] and got[5])
    if not ok:
        fail(f"the data-parallel step disagrees with the one-process step beyond {DP_BOUNDS}")
    return sum(r[name]["launches"] for r in ranks for name in configs)


def dp_cli_phase(torch, smi):
    """Phase 10b: the training CLI with --distributed at world size 1 over
    NCCL on the card (the torchrun environment set here), over the phase-7
    dataset: 1 epoch of 1 step, then --resume for a second with val mAP;
    the checkpoint's keys are bare and it loads into from_run. Returns the
    photometric launches."""
    import tempfile

    import numpy as np

    from tdeed_tpu_torch import load_config
    from tdeed_tpu_torch.cli import train as train_cli
    from tdeed_tpu_torch.data import frames as frame_io
    from tdeed_tpu_torch.infer.predictor import SpottingPredictor
    from tdeed_tpu_torch.kernels.augment import photometric
    from tdeed_tpu_torch.parallel import mesh

    load = _TimedLoad()
    get_decoder = frame_io.get_decoder
    frame_io.get_decoder = lambda kind="auto": load
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
           "MASTER_PORT": str(mesh.free_port())}
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with tempfile.TemporaryDirectory(dir=REPO / "build") as root:
            frame_dir, data_root = _write_cli_dataset(root, np.random.default_rng(SEED + 5))
            with open(os.path.join(CONFIGS, "FineDiving", "FineDiving_small.json")) as fp:
                raw = json.load(fp)
            raw.update(frame_dir=frame_dir, save_dir=os.path.join(root, "save"),
                       store_dir=os.path.join(root, "store"), **DP_CLI_CONFIG)
            config_root = os.path.join(root, "configs")
            os.makedirs(os.path.join(config_root, "FineDiving"))

            def write_config(**kw):
                with open(os.path.join(config_root, "FineDiving", "FineDiving_small.json"),
                          "w") as fp:
                    json.dump(dict(raw, **kw), fp)

            argv = ["--model", "FineDiving_small", "--config_root", config_root,
                    "--data_root", data_root, "--no_wandb", "--distributed"]
            write_config(store_mode="store")
            try:
                train_cli.main(argv)
                fail("store mode did not exit")
            except SystemExit as e:
                if e.code not in (0, None):
                    fail(f"store mode exited with {e.code}")
            write_config(store_mode="load")
            launches = photometric.launches
            t0 = time.perf_counter()
            first = train_cli.main(argv)
            t1 = time.perf_counter()
            write_config(store_mode="load", num_epochs=2)
            resumed = train_cli.main(argv + ["--resume"])
            t2 = time.perf_counter()
            launches = photometric.launches - launches
            got = [(s["start_step"], s["end_step"], s["world"]) for s in (first, resumed)]
            if got != [(0, 1, 1), (1, 2, 1)]:
                fail(f"--distributed ran (start, end, world) {got}, not (0, 1, 1), (1, 2, 1)")
            if launches < 2:
                fail(f"--distributed launched the photometric kernel {launches} times in 2 steps")
            cfg = load_config("FineDiving_small", config_root)
            run_dir = cfg.save_dir
            with open(os.path.join(run_dir, "train_meta.json")) as fp:
                history = json.load(fp)["history"]
            if [r["epoch"] for r in history] != [0, 1] or history[1]["val_mAP"] is None:
                fail(f"--distributed wrote the history {history}")
            last = torch.load(os.path.join(run_dir, "checkpoint_last"), map_location="cpu")
            keys = list(last["model"])
            if any(k.startswith("module.") for k in keys) or last["step"] != 2:
                fail(f"checkpoint_last holds step {last['step']}, keys {keys[:3]}...")
            pred = SpottingPredictor.from_run("FineDiving_small", config_root, data_root)
            best = torch.load(os.path.join(run_dir, "checkpoint_best"), map_location="cpu")
            if not all(torch.equal(v.cpu(), best[k]) for k, v in pred.model.state_dict().items()):
                fail("from_run did not load the --distributed run's checkpoint_best")
            del pred
            log(f"[dp] 10b: cli.train --distributed at world size 1 (NCCL, torchrun "
                f"environment set here) over the phase-7 dataset: 1 epoch of 1 step in "
                f"{(t1 - t0) * 1e3:.1f} ms with its val loss, test tail and saves, then "
                f"--resume for step 2 with val mAP {history[1]['val_mAP']:.4f} in "
                f"{(t2 - t1) * 1e3:.1f} ms; {launches} photometric launches; checkpoint keys "
                f"bare; from_run loads checkpoint_best; {smi}")
            return launches
    finally:
        frame_io.get_decoder = get_decoder
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_serve_phase(torch, smi):
    """Phase 10c: spot() over 2 cards against one, bit for bit; with one
    card it says so and runs nothing."""
    import tempfile

    import numpy as np

    from tdeed_tpu_torch import load_config
    from tdeed_tpu_torch.infer.predictor import SpottingPredictor
    from tdeed_tpu_torch.models.tdeed import build_model

    count = torch.cuda.device_count()
    if count < 2:
        log(f"[dp] 10c: not run on the card: spot() over n_devices=2 needs 2 CUDA devices and "
            f"this machine has {count}; the split is held to one device bit for bit on the "
            f"CPU (tests/test_torch_ddp_serving.py, 2 replicas); {smi}")
        return
    cfg = load_config("FineDiving_small", config_root=CONFIGS)
    torch.manual_seed(SEED)
    sd = build_model(cfg, device="cuda").state_dict()
    classes = {f"class{i}": i for i in range(1, cfg.num_classes + 1)}
    with tempfile.TemporaryDirectory(dir=REPO / "build") as root:
        frame_dir = os.path.join(root, "frames")
        _write_video(frame_dir, "01__01", SPOT_FRAMES, np.random.default_rng(SEED + 4))
        for tta in (False, True):
            out, walls = [], []
            for n in (1, 2):
                pred = SpottingPredictor(cfg, sd, classes, device="cuda", n_devices=n)
                pred.decoder = np.load
                t0 = time.perf_counter()
                out.append(pred.spot(frame_dir, "01__01", hflip_tta=tta, nms="none",
                                     threshold=0.0))
                walls.append(time.perf_counter() - t0)
            if out[0] != out[1]:
                fail(f"spot() over 2 cards differs from one card (tta {tta})")
            log(f"[dp] 10c: spot() {'tta' if tta else 'plain'} over 2 cards equals one card bit "
                f"for bit ({len(out[0])} scores); wall {walls[0] * 1e3:.1f} ms on one card, "
                f"{walls[1] * 1e3:.1f} ms on 2; {smi}")


def _fixture_jpegs(h, w):
    from tdeed_tpu_torch.tools.fixtures import fixture_jpegs

    jpegs = fixture_jpegs(h, w)
    if not jpegs:
        fail(f"no committed {h}x{w} fixture JPEG")
    return jpegs


def _link_video(frame_dir, video, n, rng=None):
    """n frames of a FineDiving-layout video, each a symbolic link to one of
    the committed 256x256 fixture JPEGs, in turn (``rng`` is unused: the
    pixels are the fixtures')."""
    jpegs = _fixture_jpegs(FRAME, FRAME)
    path = os.path.join(frame_dir, video.replace("__", "/"))
    os.makedirs(path)
    for i in range(n):
        os.symlink(jpegs[i % len(jpegs)], os.path.join(path, f"{i + 1:04d}.jpg"))


def _write_phase_config(root, frame_dir, **kw):
    """FineDiving_small.json with phase 7's paths and epochs (CLI_CONFIG)
    and ``kw``, under <root>/configs; returns (config_root, its path)."""
    with open(os.path.join(CONFIGS, "FineDiving", "FineDiving_small.json")) as fp:
        raw = json.load(fp)
    raw.update(dict(CLI_CONFIG, **kw), frame_dir=frame_dir,
               save_dir=os.path.join(root, "save"), store_dir=os.path.join(root, "store"))
    config_root = os.path.join(root, "configs")
    os.makedirs(os.path.join(config_root, "FineDiving"), exist_ok=True)
    path = os.path.join(config_root, "FineDiving", "FineDiving_small.json")
    with open(path, "w") as fp:
        json.dump(raw, fp)
    return config_root, path


def toolchain_phase():
    """11a: what the native JPEG decoder needs, and whether it builds."""
    import ctypes.util

    from tdeed_tpu_torch.data import frames as frame_io
    from tdeed_tpu_torch.native import jpeg as native_jpeg

    gxx = shutil.which(native_jpeg.CXX)
    version, header = "none", None
    if gxx:
        version = subprocess.run([gxx, "--version"], capture_output=True, text=True,
                                 timeout=60).stdout.splitlines()[0]
        deps = subprocess.run([gxx, "-x", "c++", "-M", "-"], capture_output=True, text=True,
                              input="#include <cstdio>\n#include <jpeglib.h>\n", timeout=60)
        header = next((w for w in deps.stdout.split() if w.endswith("/jpeglib.h")), None)
    t0 = time.perf_counter()
    built = native_jpeg.available()
    wall = time.perf_counter() - t0
    if built:
        how = (f"built against {native_jpeg.route()} (g++ {native_jpeg.build_seconds():.1f} s, "
               f"{wall:.1f} s in all), loads {native_jpeg.libjpeg_path()} "
               f"({native_jpeg.libjpeg_soname()})")
    else:
        how = f"not built ({wall:.1f} s): {native_jpeg.error()}"
    log(f"[jpeg] 11a toolchain: g++ {gxx} ({version}); jpeglib.h {header or 'not found'}; "
        f"ctypes.util.find_library('jpeg') {ctypes.util.find_library('jpeg')}; the libjpeg "
        f"Pillow bundles {native_jpeg.bundled_libjpeg()}; os.cpu_count() {os.cpu_count()}; "
        f"decoder {how}")
    if not built:
        try:
            frame_io.get_decoder("native")
        except RuntimeError as e:
            if str(e) != native_jpeg.error():
                fail(f"get_decoder('native') raised {e!r}, not the build's message")
        else:
            fail("get_decoder('native') returned a decoder that did not build")
        log("[jpeg] the native decoder cannot be built on this machine: 11b-11d do not run, "
            "and 11e runs over phase 7's np.load seam")
    return built


def _median_s(fn):
    times = []
    for _ in range(DECODE_REPEATS):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def decode_phase(smi):
    """11b: every committed fixture against its manifest, then decode and
    decode_batch timed on the host at 256x256 and 448x796 (beside PIL and
    OpenCV where they are installed)."""
    import hashlib

    import numpy as np

    from tdeed_tpu_torch.native import jpeg as native_jpeg
    from tdeed_tpu_torch.tools.fixtures import FIXTURES

    with open(FIXTURES / "manifest.json") as fp:
        manifest = json.load(fp)
    soname = native_jpeg.libjpeg_soname()
    mismatched = []
    for f in manifest["frames"]:
        got = native_jpeg.decode(str(FIXTURES / f["file"]))
        if got.shape != (f["height"], f["width"], 3):
            fail(f"{f['file']} decoded to {got.shape}")
        if hashlib.sha256(got.tobytes()).hexdigest() != f["decoded_sha256"]:
            mismatched.append(f["file"])
    small = manifest["smallest"]
    diff = np.abs(native_jpeg.decode(str(FIXTURES / small["file"])).astype(np.int16)
                  - np.load(FIXTURES / small["decoded"]))
    n = len(manifest["frames"])
    if all(f["libjpeg"] == soname for f in manifest["frames"]):
        if mismatched:
            fail(f"with {soname}, the manifest's libjpeg, {mismatched} decode to other bits")
        log(f"[jpeg] 11b decode check: {n} fixtures bit for bit against the manifest "
            f"({soname}, as the manifest's)")
    else:
        max_abs, mean_abs = int(diff.max()), float(diff.mean())
        log(f"[jpeg] 11b decode check: {soname}, not the manifest's libjpeg.so.62: "
            f"{n - len(mismatched)} of {n} fixtures bit for bit; the smallest "
            f"({small['file']}) max abs {max_abs}, {int((diff > 0).sum())} of {diff.size} "
            f"values differ, mean abs {mean_abs:.3f} (bounds {OTHER_LIBJPEG_MAX_ABS}, "
            f"{OTHER_LIBJPEG_MEAN_ABS})")
        if max_abs > OTHER_LIBJPEG_MAX_ABS or mean_abs > OTHER_LIBJPEG_MEAN_ABS:
            fail("the decoder's libjpeg is outside the bound of another ABI's rounding")

    others = {}
    try:
        from PIL import Image

        others["PIL"] = lambda p: np.asarray(Image.open(p).convert("RGB"))
    except ImportError:
        pass
    try:
        import cv2

        others["OpenCV"] = lambda p: cv2.imread(p, cv2.IMREAD_COLOR)[:, :, ::-1]
    except ImportError:
        pass
    rates = {}
    for h, w in ((FRAME, FRAME), SNB_FRAME):
        jpegs = _fixture_jpegs(h, w)
        paths = [jpegs[i % len(jpegs)] for i in range(DECODE_BATCH)]
        kb = sum(os.path.getsize(p) for p in jpegs) / len(jpegs) / 1e3
        out = np.empty((DECODE_BATCH, h, w, 3), np.uint8)
        batch, n_ok = native_jpeg.decode_batch(paths, h, w, out=out)
        if n_ok != DECODE_BATCH or not all(
                np.array_equal(batch[i], native_jpeg.decode(paths[i])) for i in range(len(jpegs))):
            fail(f"decode_batch at {h}x{w} disagrees with decode ({n_ok} decoded)")
        one = _median_s(lambda: [native_jpeg.decode(p) for p in paths]) / DECODE_BATCH
        parts = [f"decode {one * 1e3:.3f} ms a frame ({1 / one:.0f} frames/s)"]
        rates[(h, w)] = {"decode": 1 / one}
        for t in DECODE_THREADS:
            sec = _median_s(lambda: native_jpeg.decode_batch(paths, h, w, out=out, n_threads=t))
            rates[(h, w)][f"batch{t}"] = DECODE_BATCH / sec
            parts.append(f"decode_batch of {DECODE_BATCH} on {t} thread(s) {sec * 1e3:.1f} ms "
                         f"({DECODE_BATCH / sec:.0f} frames/s)")
        for name, fn in others.items():
            sec = _median_s(lambda: [fn(p) for p in paths]) / DECODE_BATCH
            parts.append(f"{name} {sec * 1e3:.3f} ms a frame ({1 / sec:.0f} frames/s)")
        log(f"[jpeg] 11b {h}x{w} ({kb:.1f} KB files), host times, os.cpu_count() "
            f"{os.cpu_count()}: " + "; ".join(parts) + f"; {smi}")
    return rates


def jpeg_train_phase(torch, smi, root, phase7):
    """11c: phase 7's training CLI run (store, then 2 epochs) over the same
    dataset layout with every frame a symbolic link to a committed 256x256
    JPEG, read through the decoder the config names ('auto'), not a seam;
    then its loader alone over the JPEGs. Returns (config path, data root,
    the photometric launches)."""
    import numpy as np

    from tdeed_tpu_torch import load_config
    from tdeed_tpu_torch.cli import train as train_cli
    from tdeed_tpu_torch.data import frames as frame_io
    from tdeed_tpu_torch.kernels.augment import photometric
    from tdeed_tpu_torch.native import jpeg as native_jpeg

    frame_dir, data_root = _write_cli_dataset(root, np.random.default_rng(SEED + 5),
                                              _link_video)
    config_root, config = _write_phase_config(root, frame_dir, store_mode="store")
    argv = ["--model", "FineDiving_small", "--config_root", config_root,
            "--data_root", data_root, "--no_wandb"]
    try:
        train_cli.main(argv)
        fail("store mode did not exit")
    except SystemExit as e:
        if e.code not in (0, None):
            fail(f"store mode exited with {e.code}")
    _write_phase_config(root, frame_dir, store_mode="load")
    cfg = load_config("FineDiving_small", config_root)
    decoder = frame_io.get_decoder(cfg.decoder)
    if decoder is not native_jpeg.decode:
        fail(f"decoder {cfg.decoder!r} did not look up the native decoder")
    before = photometric.launches
    stats = train_cli.main(argv)
    launches = photometric.launches - before
    if launches != stats["end_step"] or stats["end_step"] != (
            CLI_CONFIG["num_epochs"] * cfg.dataset_len // cfg.batch_size):
        fail(f"the JPEG run took {stats['end_step']} steps and launched the photometric "
             f"kernel {launches} times")
    with open(os.path.join(cfg.save_dir, "train_meta.json")) as fp:
        history = json.load(fp)["history"]
    losses = [r[k] for r in history for k in ("train", "val")]
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite losses from JPEG frames: {losses}")
    _epoch_lines(cfg, stats, smi, tag="jpeg")
    frames = cfg.batch_size * cfg.clip_len
    for what, st in (("phase 7, np.load seam", phase7), ("11c, native JPEG decode", stats)):
        e = st["epochs"][-1]
        log(f"[jpeg] warm epoch ({what}): {frames * e['steps'] / e['train_s']:.0f} train "
            f"frames/s including the loader, waiting {e['wait_s'] / e['train_s']:.1%} of the "
            f"train wall; first epoch {frames * st['epochs'][0]['steps'] / st['epochs'][0]['train_s']:.0f} "
            f"frames/s, waiting {st['epochs'][0]['wait_s'] / st['epochs'][0]['train_s']:.1%}")
    log(f"[jpeg] 11c: losses {', '.join(f'{v:.4f}' for v in losses)}; {stats['end_step']} "
        f"steps, {launches} photometric launches; frame cache hit rate "
        f"{stats['frame_cache']['hit_rate']:.1%}; {smi}")
    _loader_alone(torch, cfg, decoder, smi, tag="jpeg")
    return config, data_root, launches


def jpeg_spot_phase(torch, cfg, state_dict, smi, root, phase5b):
    """11d: spot() over a 600-frame video of symbolic links to the
    committed 256x256 JPEGs, with the decoder the predictor looks up
    itself; then the same calls with that decoder timed."""
    from tdeed_tpu_torch.data.loader import FrameCache
    from tdeed_tpu_torch.infer.predictor import SpottingPredictor
    from tdeed_tpu_torch.native import jpeg as native_jpeg

    classes = {f"class{i}": i for i in range(1, cfg.num_classes + 1)}
    pred = SpottingPredictor(cfg, state_dict, classes, device="cuda")
    if pred.decoder is not native_jpeg.decode:
        fail(f"the predictor looked up {pred.decoder}, not the native decoder")
    frame_dir, video = os.path.join(root, "spot"), "01__01"
    _link_video(frame_dir, video, SPOT_FRAMES)
    for mode, tta in (("tta", True), ("plain", False)):
        walls = []
        for timed in (False, True):
            pred.decoder = _TimedLoad(native_jpeg.decode) if timed else native_jpeg.decode
            pred._cache = FrameCache(cfg.decode_cache_mb << 20)  # a new video: cold
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            events = pred.spot(frame_dir, video, SPOT_FRAMES, hflip_tta=tta)
            walls.append(time.perf_counter() - t0)
            if not events or not all(e["label"] in classes and 0 <= e["frame"] < SPOT_FRAMES
                                     and 0.0 <= e["score"] <= 1.0 for e in events):
                fail(f"spot() {mode} over JPEG frames returned {len(events)} events, or an "
                     "invalid one")
        decode = pred.decoder.seconds
        pred.decoder = native_jpeg.decode
        reads = _read_windows(pred, frame_dir, video)
        wall5b, decode5b = phase5b[mode]
        log(f"[jpeg] 11d spot {mode}, {SPOT_FRAMES} JPEG frames of {FRAME}x{FRAME}: "
            f"{walls[0] * 1e3:.1f} ms ({SPOT_FRAMES / walls[0]:.0f} frames/s); with the "
            f"decoder timed {walls[1] * 1e3:.1f} ms, decoding {decode * 1e3:.1f} ms "
            f"({decode / walls[1]:.1%} of the wall); the window reads alone {reads * 1e3:.1f} "
            f"ms; phase 5b (np.load seam) {wall5b * 1e3:.1f} ms, decoding "
            f"{decode5b / wall5b:.1%}; {len(events)} events; {smi}")


def _tool(main, argv, what):
    """Run a tool's main in process with its output captured; a tool that
    exits with a message fails the run. Returns (result, output)."""
    import contextlib
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            res = main(argv)
    except SystemExit as e:
        fail(f"{what} exited: {e.code}\n{out.getvalue()[-4000:]}")
    return res, out.getvalue(), time.perf_counter() - t0


def tools_phase(torch, smi, state_dict, config, data_root, root):
    """11e: the reference-checkpoint gate on a reference-layout .pt of the
    flagship model's weights over the test split of ``data_root`` (twice:
    for its mAP, then with --expect that mAP), overfit_check at
    OVERFIT_STEPS steps and convergence_check with its default steps.
    Returns the photometric launches."""
    from tdeed_tpu_torch.kernels.augment import photometric
    from tdeed_tpu_torch.tools import convergence_check, overfit_check
    from tdeed_tpu_torch.tools import validate_reference_checkpoint as validate

    pt = os.path.join(root, "checkpoint_best.pt")
    torch.save(state_dict, pt)
    argv = ["--checkpoint", pt, "--config", config, "--data_root", data_root]
    first, _, wall = _tool(validate.main, argv, "validate_reference_checkpoint")
    res, out, wall2 = _tool(validate.main, argv + ["--expect", str(first["map_avg"])],
                            "validate_reference_checkpoint --expect")
    verdict = [line for line in out.splitlines() if line.startswith("VERDICT")]
    if not res["gate_pass"] or len(verdict) != 1 or "within" not in verdict[0]:
        fail(f"the gate against the model's own mAP did not pass: {verdict}")
    table = ", ".join(f"{k} {res[k]:.4f}" for k in sorted(res) if k.startswith("map_"))
    log(f"[tools] 11e validate_reference_checkpoint ({res['device']}): {table} in "
        f"{wall:.1f} s; {verdict[0]} ({wall2:.1f} s)")

    before = photometric.launches
    res, _, wall = _tool(overfit_check.main, ["--device", "cuda", "--steps", str(OVERFIT_STEPS)],
                         "overfit_check")
    launches = photometric.launches - before
    if launches != OVERFIT_STEPS:
        fail(f"overfit_check launched the photometric kernel {launches} times")
    log(f"[tools] 11e overfit_check ({OVERFIT_STEPS} steps, clip 16, crop 64, bf16): first "
        f"{res['first']:.4f} -> last {res['last']:.4f} (loss every 10 steps "
        f"{', '.join(f'{v:.3f}' for v in res['losses'][::10])}), OVERFIT CHECK PASSED in "
        f"{wall:.1f} s; {smi}")

    res, _, wall = _tool(convergence_check.main, ["--device", "cuda"], "convergence_check")
    if not (math.isfinite(res["loss0_port"]) and res["tail20_port"] < res["loss0_port"]
            and 0.0 <= res["map_port"] <= 1.0):
        fail(f"convergence_check: {res}")
    log(f"[tools] 11e convergence_check ({wall:.1f} s): {json.dumps(res)}")
    return launches


class _NpLoadSeam:
    """Phase 7's seam for the tools when the native decoder cannot be
    built: every decoder lookup returns np.load, and the tools' fixture
    writer np.saves its frames."""

    def __enter__(self):
        import numpy as np

        from tdeed_tpu_torch.data import frames, loader
        from tdeed_tpu_torch.infer import windows
        from tdeed_tpu_torch.tools import fixtures

        self.saved = [(m, "get_decoder", m.get_decoder) for m in (frames, loader, windows)]
        self.saved.append((fixtures, "write_jpeg", fixtures.write_jpeg))
        for m in (frames, loader, windows):
            m.get_decoder = lambda kind="auto": np.load
        fixtures.write_jpeg = _write_frame
        return self

    def __exit__(self, *exc):
        for m, name, value in self.saved:
            setattr(m, name, value)


def host_tools_phase(torch, smi, cfg, state_dict, phase7, phase5b):
    """Phase 11 (see the module docstring). Returns the photometric
    launches of 11c and 11e."""
    import tempfile

    import numpy as np

    built = toolchain_phase()
    os.makedirs(REPO / "build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as root:
        if built:
            decode_phase(smi)
            config, data_root, launches = jpeg_train_phase(torch, smi, root, phase7)
            torch.cuda.empty_cache()
            jpeg_spot_phase(torch, cfg, state_dict, smi, root, phase5b)
            return launches + tools_phase(torch, smi, state_dict, config, data_root, root)
        with _NpLoadSeam():
            _, data_root = _write_cli_dataset(root, np.random.default_rng(SEED + 5))
            _, config = _write_phase_config(root, os.path.join(root, "frames"),
                                            store_mode="load")
            return tools_phase(torch, smi, state_dict, config, data_root, root)


def _measured(result, text, what, smi, zero_ok=("ms_by_region",)):
    """The tool's printed JSON line (the last line of its output) parses,
    equals what its main returned, names phase 1's card, and every number
    in it is finite and positive (a key of ``zero_ok`` on the path may be
    0: a region that launched nothing)."""
    try:
        printed = json.loads(text.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError) as e:
        fail(f"{what}: its last line is not JSON ({e}): {text[-2000:]}")
    if printed != json.loads(json.dumps(result)):
        fail(f"{what}: the printed JSON differs from what main returned")
    if printed.get("platform") != "gpu" or printed["card"]["smi"] != smi:
        fail(f"{what}: ran on {printed.get('platform')} {printed.get('card')}, not {smi!r}")

    def walk(obj, path):
        if isinstance(obj, dict):
            for k, v in obj.items():
                walk(v, path + (k,))
        elif isinstance(obj, list):
            for v in obj:
                walk(v, path)
        elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
            if not math.isfinite(obj) or obj < 0 or (
                    obj == 0 and not any(z in path for z in zero_ok)):
                fail(f"{what}: {'/'.join(path)} = {obj}")

    walk(printed, ())
    return printed


def measure_tools_phase(torch, smi, k1):
    """12: the measuring tools in process at reduced counts: the bench
    (3 + 10 flagship steps, 2 + 3 SoccerNet Ball steps), bench_snb's k1
    and plain variants at acc_grad_iter 2 (2 + 3 steps), bench_input on
    120 frames, profile_step with a trace of 3 steps, profile_infer at the
    SoccerNet Ball geometry at batch 4 with the window aggregation. Each
    JSON line parses, names phase 1's card and holds finite positive
    numbers; K1 launches once a micro-batch on the k1 paths and never on
    plain; the trace holds device time and every launch's device record,
    with K1's kernel among its ops once a step;
    the two aggregations give the same bits. Adds K1's time inside the
    step (from the trace) to ``k1``; returns the photometric launches."""
    import tempfile

    from tdeed_tpu_torch.kernels.augment import photometric
    from tdeed_tpu_torch.tools import bench, bench_input, bench_snb, profile_infer, profile_step

    t0 = time.perf_counter()
    launches = photometric.launches
    res, text, sec = _tool(bench.main, ["--snb_warmup", "2", "--snb_steps", "3"], "12 bench")
    out = _measured(res, text, "12 bench", smi)
    for key, want in (("train_k1_launches_per_step", 1), ("snb_k1_launches_per_step", 2)):
        if out[key] != want:
            fail(f"12 bench: {key} = {out[key]}, not {want}")
    log(f"[tools] bench ({sec:.1f} s): train {out['train_frames_per_sec']['median']:.1f} "
        f"frames/s (median of {out['train_frames_per_sec']['n']}, min "
        f"{out['train_frames_per_sec']['min']:.1f}, max {out['train_frames_per_sec']['max']:.1f}), "
        f"peak {out['train_peak_gib']:.2f} GiB; predict plain "
        f"{out['predict_frames_per_sec_plain']:.1f}, hflip {out['predict_frames_per_sec_hflip']:.1f} "
        f"frames/s; SoccerNet Ball acc 2 {out['snb_challenge_train_frames_per_sec_acc2']:.1f} "
        f"frames/s, peak {out['snb_peak_gib']:.2f} GiB; input "
        f"{out['input_frames_per_sec']:.1f} cold, {out['input_frames_per_sec_cached']:.1f} "
        f"cached; {smi}")
    log(text.strip().splitlines()[-1])
    torch.cuda.empty_cache()

    argv = ["--variants", "k1,plain", "--acc", "2", "--warmup", "2", "--steps", "3"]
    res, text, sec = _tool(bench_snb.main, argv, "12 bench_snb")
    out = _measured(res, text, "12 bench_snb", smi,
                    zero_ok=("ms_by_region", "k1_launches_per_step"))
    if out["k1"]["k1_launches_per_step"] != 2 or out["plain"]["k1_launches_per_step"] != 0:
        fail(f"12 bench_snb: K1 launches a step {out['k1']['k1_launches_per_step']} (k1), "
             f"{out['plain']['k1_launches_per_step']} (plain); want 2 and 0")
    log(f"[tools] bench_snb acc 2 ({sec:.1f} s): " + "; ".join(
        f"{v} {out[v]['step_ms']['median']:.1f} ms ({out[v]['frames_per_sec']:.1f} frames/s, "
        f"{out[v]['peak_gib']:.2f} GiB, K1 {out[v]['k1_launches_per_step']:g} a step)"
        for v in ("k1", "plain")) + f"; predict {out['predict']['frames_per_sec']:.1f} frames/s")
    torch.cuda.empty_cache()

    res, text, sec = _tool(bench_input.main, ["--frames", "120", "--batches", "3"],
                           "12 bench_input")
    try:
        printed = json.loads(text.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError) as e:
        fail(f"12 bench_input: its last line is not JSON ({e})")
    bad = {k: v for k, v in printed.items() if isinstance(v, (int, float))
           and not (math.isfinite(v) and v > 0)}
    if bad or printed != json.loads(json.dumps(res)):
        fail(f"12 bench_input: {bad or 'printed JSON differs from the result'}")
    log(f"[tools] bench_input ({sec:.1f} s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in printed.items() if k.startswith(("decode", "pipeline"))))

    with tempfile.TemporaryDirectory() as logdir:
        res, text, sec = _tool(profile_step.main, ["--trace", logdir, "--iters", "5"],
                               "12 profile_step")
    out = _measured(res, text, "12 profile_step", smi,
                    zero_ok=("ms_by_region", "host_cpu_ms_by_region", "dropped"))
    tr = out["trace"]
    k1_op = tr["ms_by_op"].get(tr["k1_kernel"]) if tr["k1_kernel"] else None
    # the trace holds every launch (device_breakdown raised on a lost
    # record): K1's kernel once a step, as the wrapper counted
    if (k1_op is None or tr["dropped"] != 0
            or not k1_op["calls"] == tr["k1_launches"] == tr["steps"]):
        fail(f"12 profile_step: K1's kernel {tr['k1_kernel']} with {k1_op} in the trace "
             f"of {tr['steps']} steps ({tr['k1_launches']} launches counted, "
             f"{tr['dropped']} of {tr['launches']} launches without a device record)")
    if tr["ms_by_region"]["K1"] < k1_op["ms"]:
        fail(f"12 profile_step: the K1 region holds {tr['ms_by_region']['K1']} ms of device "
             f"time, less than K1's kernel's {k1_op['ms']} ms: its launch is not linked")
    k1["in_step_ms"] = k1_op["ms"] / k1_op["calls"]
    log(f"[tools] profile_step ({sec:.1f} s): " + "; ".join(
        f"{k} {v['ms']['median']:.2f} ms" for k, v in out["components"].items()))
    log(f"[tools] trace of {tr['steps']} steps ({tr['launches']} kernel launches, "
        f"{tr['dropped']} lost): wall {tr['wall_ms']:.1f} ms, device busy "
        f"{tr['busy_ms']:.1f} ms, idle {tr['idle_share_untraced']:.1%} of the untraced step; "
        f"host CPU {tr['host_cpu_ms_per_step']:.1f} ms a step; K1 "
        f"{k1['in_step_ms']:.4f} ms a launch inside the step ({tr['k1_kernel'][:60]}); "
        f"by region " + ", ".join(f"{k} {v:.1f}" for k, v in tr["ms_by_region"].items()))
    log("[tools] top ops: " + "; ".join(
        f"{v['ms']:.1f} ms x{v['calls']} {k[:50]}" for k, v in list(tr["ms_by_op"].items())[:8]))
    torch.cuda.empty_cache()

    argv = ["--snb", "--batches", "4", "--agg", "--iters", "5"]
    res, text, sec = _tool(profile_infer.main, argv, "12 profile_infer")
    out = _measured(res, text, "12 profile_infer", smi)
    if out["agg"]["equal_bits"] is not True:
        fail("12 profile_infer: device and host aggregation differ")
    log(f"[tools] profile_infer ({sec:.1f} s): flagship predict "
        f"{out['predict']['frames_per_sec']:.1f} frames/s; SoccerNet Ball b4 "
        f"{out['snb']['b4']['frames_per_sec']:.1f} frames/s; {out['agg']['windows']} windows: "
        f"device aggregation {out['agg']['device_agg_s']:.2f} s, host "
        f"{out['agg']['host_agg_s']:.2f} s, the same bits; {smi}")
    torch.cuda.empty_cache()
    log(f"[tools] phase 12: {time.perf_counter() - t0:.1f} s")
    return photometric.launches - launches


def main() -> int:
    import torch

    smi = device_phase(torch)
    from tdeed_tpu_torch import load_config
    from tdeed_tpu_torch.kernels.augment import photometric

    build_phase()
    k1 = kernel_phase(torch)
    bn = bn_kernel_phase(torch)
    up = up_kernel_phase(torch)
    se_row = se_kernel_phase(torch)
    probes = probe_phase(torch)
    torch.cuda.empty_cache()
    agreement_phase(torch)

    cfg = load_config("FineDiving_small", config_root=CONFIGS)
    model, step = _trainer(torch, cfg, "cuda", cfg.crop_dim, SEED)
    log(f"[model] FineDiving_small: {cfg.feature_arch}, clip {cfg.clip_len}, "
        f"crop {cfg.crop_dim}, {sum(p.numel() for p in model.parameters())} params, "
        f"{cfg.dtype} compute")
    photometric.launches = 0
    bn_marks = [("start", bn_launches())]
    up_start = up_launches()
    se_start = se_launches()
    serve_phase(torch, cfg, model)
    phase5b = spot_phase(torch, cfg, model, smi)
    train_phase(torch, cfg, model, step)
    acc_phase(torch, cfg, model, smi)
    flagship = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del model, step
    torch.cuda.empty_cache()
    phase7 = cli_phase(torch, smi)
    flagship_launches = photometric.launches
    bn_marks.append(("phases 5-7 (FineDiving_small)", bn_launches()))
    up["launches"] = [n - n0 for n, n0 in zip(up_launches(), up_start)]
    log(f"[up] phases 5-7 launched the forward and backward kernels {up['launches']} times")
    if not all(up["launches"]):
        fail(f"the flagship's training paths launched no upsample kernel: {up['launches']}")
    se_row["launches"] = [n - n0 for n, n0 in zip(se_launches(), se_start)]
    log(f"[se] phases 5-7 launched excite, grad_sums, grad_apply "
        f"{se_row['launches']} times")
    if not all(se_row["launches"]):
        fail(f"the flagship's training paths launched no SE kernel: {se_row['launches']}")
    if flagship_launches < TRAIN_STEPS + 2 * ACC_STEPS:
        fail(f"the training steps launched the photometric kernel {flagship_launches} times")
    torch.cuda.empty_cache()
    snb = snb_phase(torch, smi)  # counts its own launches from 0
    snb_launches = snb.pop("launches")
    bn_marks.append(("phase 8 (SoccerNetBall_challenge2)", bn_launches()))
    torch.cuda.empty_cache()
    agreement_phase(torch, feature_arch="rny002_gsm")
    photometric.launches = 0
    trunks_phase(torch, smi)
    checkpoint_phase(torch, smi)
    phase9_launches = photometric.launches
    if phase9_launches != PHASE9_STEPS * (len(PHASE9_ARCHS) + 2):  # 9a, 9b off and on
        fail(f"phase 9 launched the photometric kernel {phase9_launches} times")
    export_phase(torch, smi)
    bn_marks.append(("phase 9 (the agreement on rny002_gsm, GSM and plain trunks, "
                     "checkpoint_backbone, export)", bn_launches()))
    torch.cuda.empty_cache()
    photometric.launches = 0
    rank_launches = dp_steps_phase(torch, smi)  # counted in the ranks' own processes
    dp_cli_phase(torch, smi)
    phase10_launches = photometric.launches + rank_launches
    # a launch a step: the ranks' (DP_STEPS bf16 and 1 fp32 each), the one
    # process's (bf16: DP_STEPS, its rerun and its interleaved run; fp32: 3)
    # and the CLI's 2
    if phase10_launches != DP_RANKS * (DP_STEPS + 1) + (DP_STEPS + 2) + 3 + 2:
        fail(f"phase 10 launched the photometric kernel {phase10_launches} times")
    dp_serve_phase(torch, smi)
    bn_marks.append(("phase 10 (this process: the one-process step, cli.train "
                     "--distributed; not the spawned ranks)", bn_launches()))
    torch.cuda.empty_cache()
    photometric.launches = 0
    phase11_launches = host_tools_phase(torch, smi, cfg, flagship, phase7, phase5b)
    if phase11_launches != photometric.launches:
        fail(f"phase 11 counted {phase11_launches} photometric launches of "
             f"{photometric.launches}")
    bn_marks.append(("phase 11 (cli.train from JPEG frames, tools.overfit_check)",
                     bn_launches()))
    torch.cuda.empty_cache()
    photometric.launches = 0
    phase12_launches = measure_tools_phase(torch, smi, k1)
    if phase12_launches != photometric.launches:
        fail(f"phase 12 counted {phase12_launches} photometric launches of "
             f"{photometric.launches}")
    bn_marks.append(("phase 12 (the measuring tools)", bn_launches()))
    bn["launches_by_path"] = {
        label: {k: now[k] - before[k] for k in now}
        for (_, before), (label, now) in zip(bn_marks, bn_marks[1:])}
    bn["launches"] = {k: bn_marks[-1][1][k] - bn_marks[0][1][k] for k in BN_BYTES}
    if not all(v["stats"] > 0 for v in bn["launches_by_path"].values()):
        fail(f"a training path launched no BatchNorm kernel: {bn['launches_by_path']}")
    log(f"[bn] launches by path: {json.dumps(bn['launches_by_path'])}")
    k1["launches"] = (flagship_launches + snb_launches + phase9_launches + phase10_launches
                      + phase11_launches + phase12_launches)
    k1["launches_by_path"] = {"phases 5-7 (FineDiving_small)": flagship_launches,
                              "phase 8 (SoccerNetBall_challenge2)": snb_launches,
                              "phase 9 (GSM and plain trunks, checkpoint_backbone)":
                                  phase9_launches,
                              "phase 10 (2 data-parallel ranks, the one-process step, "
                              "cli.train --distributed)": phase10_launches,
                              "phase 11 (cli.train from JPEG frames, tools.overfit_check)":
                                  phase11_launches,
                              "phase 12 (the measuring tools: bench, bench_snb, "
                              "profile_step)": phase12_launches}
    k1["max_abs_err"] = max(k1["max_abs_err"], snb["step_max_abs_err"])
    k1.update({f"snb_{k}": v for k, v in snb.items()})

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "flax", "optax", "tdeed_tpu", "tools"))
    if leaked:
        fail(f"JAX, the JAX package or the repo's JAX-side tools were imported: {leaked}")
    kernels = [k1, bn, up, se_row, *probes]
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
