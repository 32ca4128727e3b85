"""Standalone spotting CLI of the port (port of tdeed_tpu/cli/predict.py):
run a model trained by ``tdeed_tpu_torch.cli.train`` on frame directories.

Serving entry point with no reference counterpart: the reference can only
score dataset splits through its evaluators; this spots events in any
extracted video and writes an events JSON, building the model once for the
whole batch of videos. It restores the run's ``checkpoint_best`` (a run
trained with ``pretrain`` spots with the double head's head 1) and runs
on the CUDA device unless ``--device cpu`` is given; without a card it
raises, it never falls back. ``--n_devices`` above 1 is refused
(ROADMAP.md, DDP).

Usage:
    python -m tdeed_tpu_torch.cli.predict --model FineDiving_small \\
        [--frame_dir /path/frames] [--videos v1 v2 ... | --split test.json] \\
        --out events.json [--nms snms] [--threshold 0.01] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", "-m", required=True)
    p.add_argument("--config_root", default="configs")
    p.add_argument("--data_root", default="data")
    p.add_argument("--frame_dir", default=None,
                   help="override the config's frame_dir")
    p.add_argument("--videos", nargs="*", default=None,
                   help="video names (frame-dir relative); default: --split")
    p.add_argument("--split", default=None,
                   help="split JSON listing videos (e.g. data/<ds>/test.json)")
    p.add_argument("--out", default=None, help="output events JSON path")
    p.add_argument("--nms", default="snms", choices=["nms", "snms", "none"])
    p.add_argument("--threshold", type=float, default=0.01)
    p.add_argument("--n_devices", type=int, default=None,
                   help="more than 1 is refused: one card (ROADMAP.md, DDP)")
    p.add_argument("--device", default="cuda",
                   help="where the model runs (default: the CUDA device)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = get_args(argv)

    from tdeed_tpu_torch.infer.predictor import SpottingPredictor

    pred = SpottingPredictor.from_run(
        args.model, args.config_root, args.data_root,
        n_devices=args.n_devices, device=args.device,
    )
    frame_dir = args.frame_dir or pred.cfg.frame_dir

    if args.videos:
        metas = [{"video": v} for v in args.videos]
    elif args.split:
        with open(args.split) as fp:
            metas = json.load(fp)
    else:
        raise SystemExit("pass --videos or --split")

    results = pred.spot_many(
        frame_dir, metas, nms=args.nms, threshold=args.threshold
    )
    payload = [
        {"video": v, "events": ev, "num_events": len(ev)}
        for v, ev in results.items()
    ]
    text = json.dumps(payload, indent=2)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fp:
            fp.write(text)
        print(f"wrote {sum(len(e['events']) for e in payload)} events "
              f"({len(payload)} videos) -> {args.out}")
    else:
        print(text)


if __name__ == "__main__":
    main()
