"""Metrics logging: loss.json-style history + optional Weights & Biases.

The port's own copy of ``tdeed_tpu/utils/logging.py`` (held equal by
tests/test_torch_train_copies.py). The reference logs losses/epoch-times
and test mAPs to wandb project 'ExtendTDEED' and writes a loss history
next to the checkpoints (ref: train_tdeed.py:113-115,220-229,267-311).
wandb is optional here and degrades to a no-op when unavailable or
disabled.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Sequence


class MetricsLogger:
    def __init__(self, save_dir: str, cfg: Any, enable_wandb: bool = True):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)
        # (epoch history persistence lives in CheckpointManager's
        # train_meta.json/loss.json — single writer, no duplicate state)
        self._wandb = None
        if enable_wandb:
            try:
                import wandb

                wandb.init(
                    project="tdeed-tpu",
                    name=getattr(cfg, "model", "run"),
                    config=cfg.to_dict() if hasattr(cfg, "to_dict") else None,
                )
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def log_epoch(self, record: Dict[str, Any]) -> None:
        if self._wandb is not None:
            self._wandb.log(
                {
                    "train_loss": record.get("train"),
                    "val_loss": record.get("val"),
                    "val_mAP": record.get("val_mAP"),
                    "train_time": record.get("train_time"),
                    "val_time": record.get("val_time"),
                },
                step=record.get("epoch"),
            )

    def log_test(self, split: str, maps: Sequence[float], tols: Sequence[int]) -> None:
        import numpy as np

        record = {
            f"{split}_mAP@{t}": float(m) for t, m in zip(tols, maps)
        }
        record[f"{split}_avg_mAP"] = float(np.mean(list(maps)))
        with open(os.path.join(self.save_dir, f"results_{split}.json"), "w") as fp:
            json.dump(record, fp, indent=2, sort_keys=True)
        if self._wandb is not None:
            self._wandb.log(record)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
