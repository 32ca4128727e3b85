"""What the port's measuring tools share (bench, bench_snb, bench_input,
profile_step, profile_infer): the sizes and counts per device, the
flagship and SoccerNet Ball configurations, the JAX tools' synthetic
batches, the timed train steps and predict calls, and the host input
path's synthetic tree and loader run.

The sizes and counts the tools share, and bench's counts, which it takes
no flag for, stand in ``SIZES``: the card's are the JAX tools' (bench.py,
tools/bench_snb.py, tools/bench_input.py); the CPU's are tiny, for the
tests' ``--device cpu`` runs.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tdeed_tpu_torch.utils.profiling import StepTimer, peak_gib, reset_peak

# per device: flagship (batch, clip, frame, crop, predict batch), SNB
# (batch, clip, height, width), input (frame side, clip, batch, frames
# written, measured batches); the flagship's warm-up and timed steps, the
# predict calls per pass
SIZES = {
    "cuda": {"flagship": (8, 100, 256, 224, 4), "snb": (4, 100, 448, 796),
             "input": (256, 100, 8, 120, 3), "warmup": 3, "steps": 10, "predict_calls": 20},
    "cpu": {"flagship": (2, 8, 40, 32, 2), "snb": (2, 4, 32, 64), "input": (40, 8, 2, 16, 3),
            "warmup": 0, "steps": 1, "predict_calls": 1},
}
NUM_BATCHES = 2  # distinct input batches on the device, cycled across steps
PREDICT_WARMUP = 5  # untimed calls of each predict pass before the timed ones

# SNB challenge-1 training envelope (ref: configs/SoccerNetBall/
# SoccerNetBall_challenge1.json; frames ref: extract_frames_snb.py:22-23)
WIDTH, HEIGHT = 796, 448
BATCH, CLIP_LEN = 4, 100
NUM_CLASSES, PRETRAIN_CLASSES = 12, 17
RADI_DISPLACEMENT = 4
TWO_HEADS = (NUM_CLASSES + 1, PRETRAIN_CLASSES + 1)

CACHE_MB = 1024  # FrameCache budget of the cached input rows: the config's decode_cache_mb


def sizes(device) -> dict:
    return SIZES[torch.device(device).type]


def _dtype(device) -> str:
    return "bfloat16" if torch.device(device).type == "cuda" else "float32"


def flagship_config(clip_len: int, crop: int, device):
    """FineDiving_small's model (rny002_gsf, 2 SGP-Mixer layers, kernel 7),
    bf16 on the card and fp32 on the CPU."""
    from tdeed_tpu_torch.config import TDEEDConfig

    return TDEEDConfig(
        dataset="finediving", num_classes=4, clip_len=clip_len, crop_dim=crop,
        feature_arch="rny002_gsf", n_layers=2, sgp_ks=7, sgp_r=4, radi_displacement=2,
        dtype=_dtype(device),
    )


def snb_config(clip_len: int, device, **overrides):
    """SoccerNetBall_challenge1's model: full frames (no crop), kernel 9,
    displacement radius 4, the 12 + 17 class double head."""
    from tdeed_tpu_torch.config import TDEEDConfig

    return TDEEDConfig(
        dataset="soccernetball", num_classes=NUM_CLASSES, clip_len=clip_len, crop_dim=None,
        feature_arch="rny002_gsf", n_layers=2, sgp_ks=9, sgp_r=4,
        radi_displacement=RADI_DISPLACEMENT, dtype=_dtype(device), **overrides,
    )


def make_batch(r: np.random.Generator, b: int, t: int, h: int, w: int, num_classes_bg: int,
               radi: int, dataset: bool) -> Dict[str, np.ndarray]:
    """A synthetic mixup batch in the JAX tools' draw order (bench.py:107-116,
    tools/bench_snb.py:137-152): uint8 frames, labels in [0,
    num_classes_bg), displacements in [-radi, radi], then the second
    stream's; with ``dataset`` every clip tagged 1 (SoccerNet Ball's head)."""
    out = {
        "frame": r.integers(0, 256, (b, t, h, w, 3), np.uint8),
        "label": r.integers(0, num_classes_bg, (b, t)).astype(np.int32),
        "labelD": r.integers(-radi, radi + 1, (b, t)).astype(np.float32),
        "frame2": r.integers(0, 256, (b, t, h, w, 3), np.uint8),
        "label2": r.integers(0, num_classes_bg, (b, t)).astype(np.int32),
        "labelD2": r.integers(-radi, radi + 1, (b, t)).astype(np.float32),
    }
    if dataset:
        out["dataset"] = np.ones((b,), np.int32)
    return out


def on_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def time_calls(fn, inputs: Sequence, *, warmup: int, calls: int, device) -> Dict[str, float]:
    """``fn(inputs[i % len(inputs)])`` ``warmup`` times untimed, then
    ``calls`` times through a ``StepTimer`` (each call on the host clock,
    from an idle device to the end of its work): the calls' ms, median,
    min, max and n."""
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    timer = StepTimer(device)
    for i in range(calls):
        with timer.step():
            fn(inputs[(warmup + i) % len(inputs)])
    return timer.ms()


def train_steps(cfg, state_dict, batches: Sequence[dict], *, acc: int, warmup: int, steps: int,
                device, pallas_augment=None, two_heads=TWO_HEADS) -> Dict[str, object]:
    """Build ``cfg``'s model with ``state_dict`` and its training step
    (AdamW, the JAX tools' schedule), run ``warmup`` steps and time
    ``steps`` more over ``batches`` (on the device, cycled): the step's ms,
    frames/s at the median step, the peak device memory over all of them,
    K1's launches a timed step and the last loss."""
    from tdeed_tpu_torch.kernels.augment import photometric
    from tdeed_tpu_torch.models.tdeed import build_model
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_train_step

    model = build_model(cfg, two_heads, device=device)
    model.load_state_dict(state_dict)
    opt, sched = make_optimizer(model.parameters(), 8e-4, 100, 10_000)
    step = make_train_step(model, opt, sched, crop_dim=cfg.crop_dim,
                           num_classes_bg=cfg.num_classes_bg, mixup=True,
                           radi_displacement=cfg.radi_displacement, acc_grad_iter=acc,
                           pallas_augment=pallas_augment)
    losses: List[torch.Tensor] = []
    reset_peak(device)
    for i in range(warmup):
        step(batches[i % len(batches)])
    launches = photometric.launches
    # warmup=0: the warm-up steps ran above, so the launches count only timed steps
    ms = time_calls(lambda b: losses.append(step(b)["loss"]), batches, warmup=0, calls=steps,
                    device=device)
    launches = photometric.launches - launches
    frames = batches[0]["frame"].shape[0] * batches[0]["frame"].shape[1]
    return {"step_ms": ms, "frames_per_sec": frames / ms["median"] * 1e3,
            "peak_gib": peak_gib(device), "k1_launches_per_step": launches / steps,
            "loss": float(losses[-1])}


def predict_calls(model, crop_dim, radi, frames: Sequence[torch.Tensor], *, calls: int,
                  device, hflips: Sequence[bool] = (False,)) -> Dict[bool, Dict[str, object]]:
    """Time the predict step's passes ``hflips`` (False: plain, True: the
    hflip TTA) on ``frames`` (uint8 batches on the device, cycled, so
    consecutive calls see distinct inputs), interleaved call by call so
    that each pass sees the same host and device state: ``PREDICT_WARMUP``
    untimed rounds, then ``calls`` timed ones. For each pass its call's ms
    and frames/s at the median call."""
    from tdeed_tpu_torch.train.step import make_predict_step

    predict = make_predict_step(model, crop_dim=crop_dim, radi_displacement=radi)
    timers = {h: StepTimer(device) for h in hflips}
    for i in range(PREDICT_WARMUP + calls):
        f = frames[i % len(frames)]
        for h in hflips:
            if i < PREDICT_WARMUP:
                predict(f, h)
                continue
            with timers[h].step():
                predict(f, h)
    n = frames[0].shape[0] * frames[0].shape[1]
    return {h: {"call_ms": t.ms(), "frames_per_sec": n / t.ms()["median"] * 1e3}
            for h, t in timers.items()}


def synth_tree(root: str, n_frames: int, w: int, h: int) -> str:
    """Write a video dir of textured JPEGs (quality 85, camera-ish load);
    the JAX tool's frames (tools/bench_input.py:46), pixel for pixel."""
    from PIL import Image

    vdir = os.path.join(root, "video0")
    os.makedirs(vdir, exist_ok=True)
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n_frames):
        base = (
            128
            + 80 * np.sin(xx / 17.0 + i / 3.0)
            + 60 * np.cos(yy / 23.0 - i / 5.0)
        )
        img = np.stack([base, np.roll(base, i % 7, axis=1), base[::-1]], axis=-1)
        img = img + rng.normal(0, 12, img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(vdir, f"{i + 1:04d}.jpg"), quality=85
        )
    return vdir


def bench_pipeline(vdir: str, n_frames: int, clip_len: int, batch: int, n_batches: int,
                   mixup: bool, cache_mb: int = 0,
                   batches: Optional[List[Dict[str, np.ndarray]]] = None) -> Dict[str, float]:
    """Training-path frames/s (tools/bench_input.py:115): ClipSampler +
    BatchLoader over a plan whose clips tile the synthetic video (decode +
    collate + prefetch queue), after one warm batch (two with the cache:
    the second fills its LRU). Returns {"frames", "seconds", "fps"} of the
    measured batches, and with ``cache_mb`` > 0 the FrameCache's
    "hit_rate" over them. ``batches``, when given, receives every batch
    the loader yields, in order."""
    from tdeed_tpu_torch.data.clips import ClipPlan
    from tdeed_tpu_torch.data.loader import BatchLoader, ClipSampler, FrameCache

    starts = range(1, max(2, n_frames - clip_len), max(1, clip_len // 4))
    plan = ClipPlan(
        frame_paths=[[vdir, s, 0, 0, 4, clip_len] for s in starts],
        labels=[[{"label": 1, "label_idx": 3}] for _ in starts],
        labels_d=[[{"displ": 1, "label_idx": 3}] for _ in starts],
    )
    cache = FrameCache(cache_mb << 20) if cache_mb else None
    sampler = ClipSampler(plan, clip_len=clip_len, stride=1, radi_displacement=2, mixup=mixup,
                          cache=cache)
    n_warm = 1 if cache is None else 2
    loader = BatchLoader(sampler, batch_size=batch,
                         dataset_len=batch * (n_batches + 1 + n_warm),
                         num_workers=min(8, (os.cpu_count() or 1) * 2), prefetch=2)
    it = loader.epoch(0)
    seen = [] if batches is None else batches
    for _ in range(n_warm):  # warm: thread pool up, page cache / LRU hot
        seen.append(next(it))
    if cache is not None:  # count hits over the measured region only
        cache.hits = cache.misses = 0
    t0 = time.perf_counter()
    done = 0
    for b in it:
        seen.append(b)
        done += b["frame"].shape[0] * clip_len
        if done >= n_batches * batch * clip_len:
            break
    dt = time.perf_counter() - t0
    out = {"frames": done, "seconds": dt, "fps": done / dt}
    if cache is not None:
        out["hit_rate"] = cache.stats()["hit_rate"]
    for b in it:  # drain so the producer thread exits
        seen.append(b)
    return out


def cores_to_feed(target: float, fps: float, cores: int, streams: int = 1) -> float:
    """Host cores a training rate of ``target`` frames/s needs when the
    pipeline gives ``fps`` on ``cores`` cores and a trained frame decodes
    ``streams`` frames (2 with mixup and no cache)."""
    return streams * target / (fps / cores)
