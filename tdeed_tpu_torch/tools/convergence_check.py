"""Convergence-scale training of the port on the synthetic FineDiving
fixture (port of one side of tools/convergence_check.py).

    python -m tdeed_tpu_torch.tools.convergence_check [--steps 400] [--out F] \\
        [--device cuda|cpu]

The JAX tool trains the JAX step and a torch oracle from the same weights
on the same fixed batch sequence to near-overfit and evaluates both through
the protocol stack. This is the port's side of that run, with the JAX
tool's sizes (batch 2 x clip 8 of 32x32 frames, 4 classes, rny002_gsf with
1 SGP-Mixer layer, kernel 3, r 2, displacement radius 1, fp32; AdamW at
1e-3, weight decay 0.01, warmup min(50, steps/4) then cosine; 8 batches
of a 2-video, 48-frame fixture, the first 2 the val batches; a val loss
every 25 steps), the same stochastic stages off (the photometric
augmentation is the plain /255 and standardization, no dropout, no
mixup) and the same evaluation stack (sliding windows over the train
split, overlap 6, displacement decode, NMS, tolerance mAP) through the
port's own train, val and predict steps. The weights come from
``torch.manual_seed(SEED)``.

It prints and writes (``--out``) the JSON keys the JAX tool writes for
one side, with the suffix ``_port``: loss0, tail20 (the mean of the last
20 losses), best_epoch, val_losses, map, maps_per_tol and sec, beside
steps, mixup and tolerances, so that the JAX tool's JSON and this one can
be compared. It imports no JAX; tests/test_torch_tools.py holds its
step-0 loss against the JAX tool's ``jax_run`` on the same weights and
batches. The model runs on the CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

B, CLIP_LEN, SIZE = 2, 8, 32
NUM_CLASSES = 4
NC_BG = NUM_CLASSES + 1
N_LAYERS, KS, K = 1, 3, 2.0
LR, WD = 1e-3, 0.01
STEPS_PER_EPOCH = 25
SEED = 3


def classes() -> dict:
    return {f"class{i}": i for i in range(1, NUM_CLASSES + 1)}


def initial_model(device: str):
    """The run's model with its initial weights (fp32, from SEED)."""
    from tdeed_tpu_torch.config import TDEEDConfig
    from tdeed_tpu_torch.models.tdeed import build_model

    cfg = TDEEDConfig(
        dataset="finediving", num_classes=NUM_CLASSES, clip_len=CLIP_LEN, crop_dim=-1,
        feature_arch="rny002_gsf", n_layers=N_LAYERS, sgp_ks=KS, sgp_r=K,
        radi_displacement=1, dtype="float32",
    )
    torch.manual_seed(SEED)
    return build_model(cfg, device=device)


def build_batches(fixture, n_batches):
    """Decode a fixed batch sequence once; the run replays it."""
    from tdeed_tpu_torch.data.clips import plan_clips
    from tdeed_tpu_torch.data.loader import BatchLoader, ClipSampler

    plan = plan_clips(
        "finediving",
        os.path.join(fixture["data_root"], "finediving", "train.json"),
        fixture["frame_dir"], classes(), CLIP_LEN, 1, 0.5, 1,
    )
    sampler = ClipSampler(plan, CLIP_LEN, 1, 1, mixup=False)
    loader = BatchLoader(sampler, B, dataset_len=B * n_batches, num_workers=2, seed=11)
    return list(loader.epoch(0))


def _neutral_preprocess(frames, params):
    """The photometric stage off: /255 and the ImageNet standardization."""
    from tdeed_tpu_torch.train.augment import standardize

    return standardize(frames.float() / 255.0)


def port_run(batches, val_batches, steps, model, warmup, cosine):
    """(train losses, val losses): ``steps`` steps cycling ``batches``, the
    mean val loss over ``val_batches`` every STEPS_PER_EPOCH steps."""
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_train_step, make_val_step

    opt, sched = make_optimizer(model.parameters(), LR, warmup, cosine, weight_decay=WD)
    step = make_train_step(model, opt, sched, crop_dim=None, num_classes_bg=NC_BG,
                           mixup=False, radi_displacement=1, pallas_augment=False)
    step.preprocess = _neutral_preprocess
    val_step = make_val_step(model, crop_dim=None, num_classes_bg=NC_BG, radi_displacement=1)
    keys = ("frame", "label", "labelD")
    losses, val_losses = [], []
    for s in range(steps):
        batch = {k: batches[s % len(batches)][k] for k in keys}
        draws = step.draw(batch)
        for d in draws:
            d.dropout_keep = {}  # no dropout
        losses.append(float(step(batch, draws)["loss"]))
        if (s + 1) % STEPS_PER_EPOCH == 0:
            val_losses.append(float(np.mean([
                float(val_step({k: vb[k] for k in keys})["loss"]) for vb in val_batches])))
    return losses, val_losses


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="where the model runs (default: the CUDA device)")
    args = p.parse_args(argv)

    from tdeed_tpu_torch.infer.evaluate import evaluate
    from tdeed_tpu_torch.infer.windows import VideoWindows
    from tdeed_tpu_torch.tools.fixtures import make_finediving_fixture
    from tdeed_tpu_torch.train.step import make_predict_step

    model = initial_model(args.device)
    warmup = min(2 * STEPS_PER_EPOCH, args.steps // 4)
    cosine = max(args.steps - warmup, 1)

    with tempfile.TemporaryDirectory() as root:
        fixture = make_finediving_fixture(root, num_videos=2, num_frames=48, size=SIZE)
        batches = build_batches(fixture, 8)
        t0 = time.time()
        losses, val_losses = port_run(batches, batches[:2], args.steps, model, warmup, cosine)
        if args.device != "cpu":
            torch.cuda.synchronize()
        sec = time.time() - t0

        # --- final eval through the protocol stack ------------------------
        windows = VideoWindows(
            "finediving",
            os.path.join(fixture["data_root"], "finediving", "train.json"),
            fixture["frame_dir"], CLIP_LEN, overlap_len=CLIP_LEN * 3 // 4, stride=1,
        )
        predict = make_predict_step(model, crop_dim=None, radi_displacement=1)
        maps, tols = evaluate(lambda frames, hflip=False: predict(frames, hflip)[1], windows,
                              "TEST", classes(), printed=False, test=True, augment=False)

    res = {
        "steps": args.steps,
        "mixup": False,
        "tolerances": list(tols),
        "device": str(next(model.parameters()).device),
        "loss0_port": losses[0],
        "tail20_port": float(np.mean(losses[-20:])),
        "best_epoch_port": int(np.argmin(val_losses)) if val_losses else None,
        "val_losses_port": [round(v, 4) for v in val_losses],
        "map_port": round(float(np.mean(maps)), 4),
        "maps_per_tol_port": [round(float(m), 4) for m in maps],
        "sec_port": round(sec, 1),
    }
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as fp:
            json.dump(res, fp, indent=2)
    return res


if __name__ == "__main__":
    main()
