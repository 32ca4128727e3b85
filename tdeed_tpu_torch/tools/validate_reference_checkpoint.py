"""Reference-checkpoint quality gate: load -> evaluate -> verdict (port of
tools/validate_reference_checkpoint.py).

    python -m tdeed_tpu_torch.tools.validate_reference_checkpoint \\
        --checkpoint /path/checkpoint_best.pt \\
        --config configs/FineDiving/FineDiving_small.json \\
        --frame_dir /path/frames [--data_root data] [--labels_root ...] \\
        [--split test] [--expect 84.36 --metric map_avg] [--tolerance 0.5] \\
        [--device cuda|cpu]

The reference's evidence is its released checkpoints (ref:
README.md:19,58-63); BASELINE.md defines the gate as "tight mAP within
0.5" of those numbers. The port names its modules as the reference's
state_dict does (models/tdeed.py), so a reference ``checkpoint_best.pt``
loads with ``torch.load(weights_only=True)`` and
``TDEED.load_state_dict(strict=True)``, with no conversion; a directory is
a port run directory, whose ``checkpoint_best`` (checkpoint.py) is loaded.
Then the split is evaluated as the reference's test tail does (ref:
train_tdeed.py:240-311) through the port's ``infer.evaluate``: sliding
windows at the dataset's eval stride and overlap, the dataset's hflip TTA,
displacement decode, the high-recall store, NMS/SNMS and tolerance mAP,
plus the SoccerNet tight/loose a-mAP scorers for SN/SNB with
``--save_pred``. It prints the mAP table and, with ``--expect``, the
verdict line (the JAX tool's, ending "PASS (within tolerance)" or "FAIL
(outside tolerance)"). The model runs on the CUDA device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict

import numpy as np
import torch


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", required=True,
                   help="reference checkpoint_best.pt (torch state_dict) or a port "
                        "run directory holding checkpoint_best")
    p.add_argument("--config", required=True,
                   help="model config JSON path (or model name under --config_root)")
    p.add_argument("--config_root", default="configs")
    p.add_argument("--frame_dir", default=None, help="override the config's frame_dir")
    p.add_argument("--data_root", default="data",
                   help="dataset metadata root (<ds>/{split}.json, class.txt)")
    p.add_argument("--labels_root", default=None,
                   help="external label tree (SN/SNB); default: "
                        "<data_root>/<ds>/labels_path.txt indirection")
    p.add_argument("--split", default="test")
    p.add_argument("--expect", type=float, default=None,
                   help="published reference number to gate against (BASELINE.md)")
    p.add_argument("--metric", default="map_avg",
                   help="which reported metric the gate compares: map_avg, map_tol<k>, "
                        "or (SN/SNB) amap_tight / amap_loose")
    p.add_argument("--tolerance", type=float, default=0.5,
                   help="gate width in mAP points (BASELINE.md: 0.5)")
    p.add_argument("--out", default=None, help="write the result JSON here")
    p.add_argument("--save_pred", default=None,
                   help="also store per-video predictions under this prefix")
    p.add_argument("--device", default="cuda",
                   help="where the model runs (default: the CUDA device)")
    return p.parse_args(argv)


def load_weights(checkpoint: str) -> Dict[str, torch.Tensor]:
    """The state_dict of a reference ``.pt`` file (a state_dict, or a module
    saved whole) or of a port run directory's checkpoint_best, on the CPU."""
    if os.path.isdir(checkpoint):
        from tdeed_tpu_torch.checkpoint import CheckpointManager

        return CheckpointManager(checkpoint).restore_best()
    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    return sd.state_dict() if hasattr(sd, "state_dict") else sd


def main(argv=None) -> dict:
    args = get_args(argv)

    from tdeed_tpu_torch.config import config_path_for_model, load_config
    from tdeed_tpu_torch.data.loader import FrameCache
    from tdeed_tpu_torch.data.registry import get_spec, load_classes
    from tdeed_tpu_torch.infer.evaluate import evaluate
    from tdeed_tpu_torch.infer.predictor import SpottingPredictor
    from tdeed_tpu_torch.infer.windows import VideoWindows
    from tdeed_tpu_torch.models.tdeed import two_heads_for

    cfg_path = (args.config if args.config.endswith(".json")
                else config_path_for_model(args.config_root, args.config))
    cfg = load_config(cfg_path)
    if args.frame_dir:
        cfg = dataclasses.replace(cfg, frame_dir=args.frame_dir)
    spec = get_spec(cfg.dataset)

    labels_root = args.labels_root
    if labels_root is None:
        lp = os.path.join(args.data_root, cfg.dataset, "labels_path.txt")
        if os.path.exists(lp):
            with open(lp) as fp:
                labels_root = fp.read().strip()

    classes = load_classes(os.path.join(args.data_root, cfg.dataset, "class.txt"))
    # load_state_dict(strict=True) inside: every reference key, no other
    pred = SpottingPredictor(cfg, load_weights(args.checkpoint), classes,
                             device=args.device, two_heads=two_heads_for(cfg))

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
    maps, tols = evaluate(
        pred.predict_fn, data, args.split.upper(), classes,
        save_pred=args.save_pred, printed=True, test=True,
        augment=spec.hflip_tta, labels_root=labels_root,
    )

    res = {"checkpoint": args.checkpoint, "config": cfg_path, "split": args.split,
           "device": str(pred.device)}
    if tols is not None:
        res["tolerances"] = list(tols)
    if maps is not None:  # CHALLENGE splits are label-free: no mAP table
        res["map_avg"] = round(float(np.mean(maps)) * 100, 4)
        for t, m in zip(tols, maps):
            res[f"map_tol{t}"] = round(float(m) * 100, 4)

    if args.save_pred and cfg.dataset in ("soccernet", "soccernetball"):
        from tdeed_tpu_torch.metrics.soccernet import evaluate_sn_official, evaluate_snb

        # the JSON writers put per-game results_spotting.json trees under
        # <dirname(save_pred)>/preds (utils/io.py)
        pred_dir = os.path.join(os.path.dirname(args.save_pred) or ".", "preds")
        scorer = evaluate_sn_official if cfg.dataset == "soccernet" else evaluate_snb
        try:
            sn = scorer(labels_root, pred_dir, args.split)
        except Exception as e:  # label tree absent in CHALLENGE-style runs
            print(f"SoccerNet scorer skipped: {e!r}")
        else:
            if isinstance(sn, dict):
                for k, v in sn.items():
                    if isinstance(v, (int, float)):
                        res[f"amap_{k}"] = round(float(v), 4)

    # --- verdict table ----------------------------------------------------
    print("\n=== reference-checkpoint quality gate ===")
    for k in sorted(res):
        if k.startswith(("map_", "amap_")):
            print(f"  {k:>12}: {res[k]:.4f}")
    if args.expect is not None:
        got = res.get(args.metric)
        if got is None:
            raise ValueError(f"--metric {args.metric} not in results {sorted(res)}")
        res["expect"] = args.expect
        res["gate_metric"] = args.metric
        res["gate_delta"] = round(got - args.expect, 4)
        res["gate_pass"] = bool(abs(got - args.expect) <= args.tolerance)
        print(
            f"VERDICT: {args.metric}={got:.4f} vs reference "
            f"{args.expect:.4f} (delta {res['gate_delta']:+.4f}, "
            f"tolerance {args.tolerance}) -> "
            + ("PASS (within tolerance)" if res["gate_pass"] else "FAIL (outside tolerance)")
        )
    if args.out:
        with open(args.out, "w") as fp:
            json.dump(res, fp, indent=2)
    return res


if __name__ == "__main__":
    main()
