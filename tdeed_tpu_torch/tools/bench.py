"""Benchmark of the port on one card: training and predict throughput at
the flagship envelope, SoccerNet Ball challenge training, and the host
input path (port of bench.py).

    python -m tdeed_tpu_torch.tools.bench [--snb_warmup 2] [--snb_steps 10] \\
        [--device cuda|cpu]

1. Flagship training (FineDiving_small: rny002_gsf, batch 8 x clip 100 of
   256x256 uint8 frames cropped to 224, mixup, bf16 compute, AdamW, K1 on):
   bench.py's synthetic batches (numpy's default_rng(0) in its draw
   order), two distinct batches on the card before timing, cycled; 3
   warm-up steps, then 10 timed steps, each on the host clock and ending
   in ``torch.cuda.synchronize()``. ``train_frames_per_sec`` is the
   median over the timed steps with n, min and max.
2. Predict (bench.py's eval batch 4, frames on the card, the center crop):
   20 calls plain and 20 with the hflip TTA, interleaved call by call
   after 5 untimed rounds, two distinct batches cycled.
3. SoccerNet Ball challenge training (tools/bench_snb.py's envelope,
   SoccerNetBall_challenge1: batch 4 x clip 100 of 448x796, acc_grad_iter
   2), ``--snb_warmup`` + ``--snb_steps`` steps. bench.py runs it on a TPU
   only; here it always runs.
4. The host input path (tools/bench_input.py): ClipSampler + BatchLoader
   over a synthetic 256x256 JPEG tree of 120 frames, 3 measured batches,
   cold and through the FrameCache, and the host cores the measured
   training rate needs.

The counts and sizes stand in measure.SIZES. Each part reports its peak
device memory; the training parts K1's launches a step. A failing part
fails the run (no fallback to the plain graph, no part left out).
Prints one JSON line, with the card's name, power limit and count.

Without a card it exits non-zero. ``--device cpu`` runs every part on the
host at a tiny size (SIZES["cpu"], fp32): its JSON says "platform": "cpu"
and holds no device memory.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from tdeed_tpu_torch.tools import measure
from tdeed_tpu_torch.utils.profiling import peak_gib, platform, reset_peak


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--snb_warmup", type=int, default=2)
    p.add_argument("--snb_steps", type=int, default=10)
    p.add_argument("--device", default="cuda", help="where the model runs (default: the card)")
    args = p.parse_args(argv)
    if args.snb_steps < 1:
        p.error("--snb_steps must be at least 1")
    dev = args.device
    where = platform("bench", dev)
    sizes = measure.sizes(dev)

    from tdeed_tpu_torch.models.tdeed import build_model

    # --- 1. flagship training ---------------------------------------------
    b, t, frame, crop, pb = sizes["flagship"]
    cfg = measure.flagship_config(t, crop, dev)
    r = np.random.default_rng(0)
    batches = [measure.on_device(measure.make_batch(
        r, b, t, frame, frame, cfg.num_classes_bg, cfg.radi_displacement, False), dev)
        for _ in range(measure.NUM_BATCHES)]
    torch.manual_seed(0)
    init = build_model(cfg, device="cpu").state_dict()
    train = measure.train_steps(cfg, init, batches, acc=1, warmup=sizes["warmup"],
                                steps=sizes["steps"], device=dev, two_heads=None)
    frames_per_step = b * t
    fps = [frames_per_step / (ms / 1e3) for ms in (train["step_ms"]["max"],
                                                   train["step_ms"]["median"],
                                                   train["step_ms"]["min"])]
    out = {"tool": "bench", "metric": "train_frames_per_sec", "value": fps[1],
           "unit": "frames/s", **where,
           "train_frames_per_sec": {"median": fps[1], "min": fps[0], "max": fps[2],
                                    "n": train["step_ms"]["n"]},
           "train_step_ms": train["step_ms"], "train_peak_gib": train["peak_gib"],
           "train_k1_launches_per_step": train["k1_launches_per_step"],
           "train_loss": train["loss"]}
    del batches
    print(f"[train] {fps[1]:.1f} frames/s (median of {sizes['steps']} steps)", flush=True)

    # --- 2. predict (eval protocol batch, frames on the card) -----------
    model = build_model(cfg, device=dev)
    model.load_state_dict(init)
    pframes = [torch.from_numpy(r.integers(0, 253, (pb, t, frame, frame, 3), np.uint8)).to(dev)
               for _ in range(measure.NUM_BATCHES)]
    reset_peak(dev)
    res = measure.predict_calls(model, crop, cfg.radi_displacement, pframes,
                                calls=sizes["predict_calls"], device=dev, hflips=(False, True))
    for name, hflip in (("plain", False), ("hflip", True)):
        out[f"predict_frames_per_sec_{name}"] = res[hflip]["frames_per_sec"]
        out[f"predict_call_ms_{name}"] = res[hflip]["call_ms"]
    out["predict_peak_gib"] = peak_gib(dev)
    del model, pframes
    print(f"[predict] plain {out['predict_frames_per_sec_plain']:.1f}, hflip "
          f"{out['predict_frames_per_sec_hflip']:.1f} frames/s", flush=True)

    # --- 3. SoccerNet Ball challenge training at acc_grad_iter 2 --------
    sb, st, sh, sw = sizes["snb"]
    snb_cfg = measure.snb_config(st, dev)
    snb_batches = [measure.on_device(measure.make_batch(
        r, sb, st, sh, sw, measure.NUM_CLASSES + 1, measure.RADI_DISPLACEMENT, True), dev)
        for _ in range(measure.NUM_BATCHES)]
    torch.manual_seed(0)
    snb_init = build_model(snb_cfg, measure.TWO_HEADS, device="cpu").state_dict()
    snb = measure.train_steps(snb_cfg, snb_init, snb_batches, acc=2,
                              warmup=args.snb_warmup, steps=args.snb_steps, device=dev)
    del snb_batches
    reset_peak(dev)
    snb_fps = sb * st / (snb["step_ms"]["median"] / 1e3)
    out.update({"snb_challenge_train_frames_per_sec_acc2": snb_fps,
                "snb_step_ms": snb["step_ms"], "snb_peak_gib": snb["peak_gib"],
                "snb_k1_launches_per_step": snb["k1_launches_per_step"],
                "snb_loss": snb["loss"]})
    print(f"[snb] {snb_fps:.1f} frames/s at acc_grad_iter 2", flush=True)

    # --- 4. host input path -------------------------------------------
    side, clip, batch, n_frames, n_batches = sizes["input"]
    cores = os.cpu_count() or 1
    with tempfile.TemporaryDirectory() as root:
        vdir = measure.synth_tree(root, n_frames, side, side)
        cold = measure.bench_pipeline(vdir, n_frames, clip, batch, n_batches, mixup=False)
        cached = measure.bench_pipeline(vdir, n_frames, clip, batch, n_batches, mixup=False,
                                        cache_mb=measure.CACHE_MB)
    out.update({"input_frames_per_sec": cold["fps"],
                "input_frames_per_sec_cached": cached["fps"],
                "input_cache_hit_rate": cached["hit_rate"], "input_cores": cores,
                # with mixup the loader delivers two frames per trained frame
                "input_cores_to_feed_train": measure.cores_to_feed(
                    fps[1], cold["fps"], cores, streams=2),
                "input_cores_to_feed_train_cached": measure.cores_to_feed(
                    fps[1], cached["fps"], cores, streams=2)})
    print(f"[input] {cold['fps']:.1f} frames/s cold, {cached['fps']:.1f} cached", flush=True)

    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
