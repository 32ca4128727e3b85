"""Challenge-evaluation CLI of the port (port of
tdeed_tpu/cli/evaluate_challenge.py, on one card): inference only, on the
SoccerNet Ball challenge split.

Parity with the reference entry point (ref: evaluate_tdeed_challenge.py:35-141):
the config's dataset must be 'soccernetball'; the run's best checkpoint
is restored (a config with ``pretrain`` builds the FC2 double head and
scores with head 1), and the label-free CHALLENGE path of
``infer.evaluate.evaluate`` Soft-NMS-filters the events and writes one
``preds/<game>/results_spotting.json`` per game under the run's save_dir,
for submission.

Usage:
    python -m tdeed_tpu_torch.cli.evaluate_challenge --model SoccerNetBall_challenge2
        [--split challenge] [--device cuda|cpu] [--n_devices N]

It runs on the CUDA device unless ``--device cpu`` is given; without a
card it raises, it never falls back. ``--n_devices N`` splits each window
batch over replicas on cuda:0..N-1, the batch rounded up to a multiple of
N as the JAX CLI rounds it.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict


def get_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", "-m", required=True)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--config_root", default="configs")
    parser.add_argument("--data_root", default="data")
    parser.add_argument("--split", default="challenge")
    parser.add_argument("--n_devices", type=int, default=None,
                        help="split each window batch over replicas on cuda:0..N-1 "
                             "(N on the CPU with --device cpu)")
    parser.add_argument("--device", default="cuda",
                        help="where the model runs (default: the CUDA device)")
    return parser.parse_args(argv)


def main(argv=None) -> Dict:
    """Run the CLI. Returns {'preds_root': the directory of the per-game
    results_spotting.json files, 'videos': the split's videos, 'seconds':
    the wall time of the inference and the writes}."""
    args = get_args(argv)

    from tdeed_tpu_torch.cli.train import labels_root_for, seed_everything
    from tdeed_tpu_torch.config import load_config
    from tdeed_tpu_torch.parallel import mesh

    seed_everything(args.seed)  # ref: evaluate_tdeed_challenge.py:38-41
    cfg = load_config(args.model, args.config_root)
    if cfg.dataset != "soccernetball":
        # ref: evaluate_tdeed_challenge.py:47
        raise ValueError(f"challenge evaluation takes soccernetball, not {cfg.dataset!r}")
    mesh.serving_devices(args.device, args.n_devices)  # too many cards: raise before any read

    from tdeed_tpu_torch.data.loader import FrameCache
    from tdeed_tpu_torch.data.registry import get_spec
    from tdeed_tpu_torch.infer.evaluate import evaluate
    from tdeed_tpu_torch.infer.predictor import SpottingPredictor
    from tdeed_tpu_torch.infer.windows import VideoWindows

    # the run's best checkpoint; a config with ``pretrain`` scores with head 1
    pred = SpottingPredictor.from_run(args.model, args.config_root, data_root=args.data_root,
                                      device=args.device, n_devices=args.n_devices)
    save_dir = cfg.save_dir or os.path.join("checkpoints", cfg.model)
    spec = get_spec(cfg.dataset)
    labels_root = labels_root_for(args.data_root, cfg.dataset)

    t0 = time.time()
    data = VideoWindows(
        cfg.dataset,
        os.path.join(args.data_root, cfg.dataset, f"{args.split}.json"),
        cfg.frame_dir,
        cfg.clip_len,
        overlap_len=spec.eval_overlap_len(cfg.clip_len),
        stride=spec.eval_stride,
        labels_root=labels_root,
        decoder=pred.decoder,
        cache=FrameCache(cfg.decode_cache_mb << 20) if cfg.decode_cache_mb > 0 else None,
    )
    evaluate(
        pred.predict_fn,
        data,
        "CHALLENGE",
        pred.classes,
        save_pred=os.path.join(save_dir, f"pred-{args.split}"),
        test=True,
        augment=False,
        labels_root=labels_root,
        # over N replicas the predictor's batch, a multiple of N (JAX
        # cli/evaluate_challenge.py:82-90)
        batch_size=pred.batch_size if len(pred.devices) > 1 else None,
    )
    seconds = time.time() - t0
    print("CORRECTLY FINISHED CHALLENGE INFERENCE")
    return {"preds_root": os.path.join(save_dir, "preds"),
            "videos": [v for v, _, _ in data.videos], "seconds": seconds}


if __name__ == "__main__":
    main()
