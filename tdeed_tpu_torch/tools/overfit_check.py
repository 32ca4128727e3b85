"""Learning-dynamics check: overfit one fixed batch (port of
tools/overfit_check.py).

    python -m tdeed_tpu_torch.tools.overfit_check [--steps 150] [--target 1.0] \\
        [--clip_len 16] [--crop 64] [--dtype bfloat16|float32] [--device cuda|cpu]

The training step (``train.step.make_train_step``, mixup off) takes
``--steps`` steps on one fixed random batch of 4 clips (uint8 frames,
labels and displacement targets from numpy's default_rng(0)) with the
JAX tool's model (rny002_gsf, 4 classes, 2 SGP-Mixer layers, kernel 3,
r 2, displacement radius 1, the config's bf16 compute unless ``--dtype``
says otherwise) and optimizer (AdamW at 2e-3, 5 warmup steps, cosine over
10x the steps). The photometric augmentation stays on,
so the loss floor is not zero but must drop hard. The rule is the JAX
tool's: the last loss under ``--target`` and under a quarter of the
first. The model runs on the CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

BATCH = 4


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--target", type=float, default=1.0)
    p.add_argument("--clip_len", type=int, default=16)
    p.add_argument("--crop", type=int, default=64)
    p.add_argument("--dtype", default="bfloat16",
                   help="compute dtype (float32 on the CPU: oneDNN's bf16 convolutions are "
                        "slow there and leave padding-only weight-gradient taps unset)")
    p.add_argument("--device", default="cuda",
                   help="where the model runs (default: the CUDA device)")
    args = p.parse_args(argv)

    from tdeed_tpu_torch.config import TDEEDConfig
    from tdeed_tpu_torch.models.tdeed import build_model
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_train_step

    t, s = args.clip_len, args.crop
    cfg = TDEEDConfig(
        dataset="finediving", num_classes=4, clip_len=t, crop_dim=s,
        feature_arch="rny002_gsf", n_layers=2, sgp_ks=3, sgp_r=2,
        radi_displacement=1, dtype=args.dtype,
    )
    torch.manual_seed(0)
    model = build_model(cfg, device=args.device)
    r = np.random.default_rng(0)
    batch = {
        "frame": r.integers(0, 256, (BATCH, t, s, s, 3), np.uint8),
        "label": r.integers(0, 5, (BATCH, t)).astype(np.int64),
        "labelD": r.integers(-1, 2, (BATCH, t)).astype(np.float32),
    }
    batch = {k: torch.from_numpy(v).to(args.device) for k, v in batch.items()}
    opt, sched = make_optimizer(model.parameters(), 2e-3, 5, 10 * args.steps)
    # mixup off: a fixed batch must be memorizable exactly
    step = make_train_step(model, opt, sched, crop_dim=s, num_classes_bg=5, mixup=False,
                           radi_displacement=1, seed=7)

    losses = []
    for i in range(args.steps):
        losses.append(float(step(batch)["loss"]))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:3d}: loss {losses[-1]:.4f}", flush=True)
    first, last = losses[0], losses[-1]
    print(f"first {first:.4f} -> last {last:.4f}")
    if not (last < args.target and last < first * 0.25):
        raise SystemExit(f"did not overfit: {first:.4f} -> {last:.4f}")
    print("OVERFIT CHECK PASSED")
    return {"first": first, "last": last, "steps": args.steps, "losses": losses}


if __name__ == "__main__":
    main()
