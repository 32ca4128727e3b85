"""Export a finished run's predict step as a ``torch.export`` serving
artifact (port of tdeed_tpu/cli/export_model.py).

Usage:
    python -m tdeed_tpu_torch.cli.export_model <model_name> <out_dir>
        [--config_root configs] [--data_root data] [--batch_size 4]
        [--frame_hw H,W] [--device cuda|cpu]

Restores the run's config and best checkpoint as
``SpottingPredictor.from_run`` does (``infer.predictor.restore_run``) and
writes a self-contained export directory (see tdeed_tpu_torch/infer/
export.py). The programs run on the device they are exported on: the
CUDA device unless ``--device cpu`` is given; without a card it raises,
it never falls back. No reference counterpart: the reference deploys by
shipping its source tree (ref: README.md:40-63).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
    """Run the CLI; returns the export directory."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_name")
    p.add_argument("out_dir")
    p.add_argument("--config_root", default="configs")
    p.add_argument("--data_root", default="data")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--frame_hw", default=None,
                   help="stored frame H,W (default: crop_dim,crop_dim)")
    p.add_argument("--device", default="cuda",
                   help="where the exported programs run (default: the CUDA device)")
    args = p.parse_args(argv)

    from tdeed_tpu_torch.infer.evaluate import INFERENCE_BATCH_SIZE
    from tdeed_tpu_torch.infer.export import export_predictor
    from tdeed_tpu_torch.infer.predictor import restore_run

    cfg, state_dict, classes, two_heads = restore_run(
        args.model_name, args.config_root, args.data_root)
    frame_hw = None
    if args.frame_hw:
        h, w = args.frame_hw.split(",")
        frame_hw = (int(h), int(w))
    out = export_predictor(
        cfg, state_dict, classes, args.out_dir,
        two_heads=two_heads,
        batch_size=args.batch_size or INFERENCE_BATCH_SIZE,
        frame_hw=frame_hw,
        device=args.device,
    )
    print(f"exported {args.model_name} -> {out}")
    return out


if __name__ == "__main__":
    main()
