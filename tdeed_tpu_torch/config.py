"""Config system: typed dataclasses, JSON-compatible with the reference keys.

The port's own copy of ``tdeed_tpu/config.py``: the same fields, defaults
and loading rules, so one JSON file gives the same config to both
packages (held equal by tests/test_torch_config.py). Fields that only the
JAX package reads (mesh axis, Orbax backbone checkpoint, the fused-block
knobs) stay, so that a config round-trips unchanged; the port refuses the
values it does not carry (models/tdeed.py:check_supported).

The reference merges ``config/<Dataset>/<Dataset>_<name>.json`` onto an
argparse namespace (ref: train_tdeed.py:45-77, config/README.md:3-29). Here
the same keys deserialize into a dataclass, plus knobs (dtype, mesh axis)
that have no reference counterpart.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional


@dataclasses.dataclass
class PretrainConfig:
    """Joint-pretraining sub-config (ref: train_tdeed.py:72-75)."""

    dataset: str
    num_classes: int
    frame_dir: str = ""
    store_dir: str = ""

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PretrainConfig":
        return cls(
            dataset=d["dataset"],
            num_classes=int(d["num_classes"]),
            frame_dir=d.get("frame_dir", ""),
            store_dir=d.get("store_dir", ""),
        )


@dataclasses.dataclass
class TDEEDConfig:
    """Full model/training configuration.

    Field names match the reference JSON keys one-to-one
    (ref: config/README.md:3-29) so existing config files load unchanged.
    """

    # Identification
    model: str = "FineDiving_small"
    seed: int = 1

    # Paths
    frame_dir: str = ""
    save_dir: str = ""
    store_dir: str = ""
    store_mode: str = "load"  # 'store' | 'load'

    # Data
    dataset: str = "finediving"
    clip_len: int = 100
    crop_dim: Optional[int] = 224  # None/-1 => no crop
    epoch_num_frames: int = 500_000
    mixup: bool = True
    modality: str = "rgb"
    num_classes: int = 4
    radi_displacement: int = 2
    num_workers: int = 4

    # Model
    feature_arch: str = "rny002_gsf"  # rny{002,008}_{gsm,gsf} or plain rny002
    temporal_arch: str = "ed_sgp_mixer"
    n_layers: int = 2
    sgp_ks: int = 7
    sgp_r: float = 4

    # Optimization
    batch_size: int = 8
    learning_rate: float = 8e-4
    num_epochs: int = 50
    warm_up_epochs: int = 3
    acc_grad_iter: int = 1
    start_val_epoch: int = 30
    criterion: str = "map"  # 'map' | 'loss'
    only_test: bool = False

    # Joint pretraining (SNB + SN double head)
    pretrain: Optional[PretrainConfig] = None

    # Split selection. The reference hardcodes train/val and expects users
    # to swap data/<ds>/train.json for the challenge variants by hand; here
    # the SNB challenge-training flow is first-class: set
    # train_split="train_challenge", val_split="val_challenge"
    # (ref: data/soccernetball/{train,val}_challenge.json,
    # evaluate_tdeed_challenge.py:29).
    train_split: str = "train"
    val_split: str = "val"

    # --- TPU-specific (no reference counterpart) ---
    # Orbax dir with ImageNet-pretrained backbone weights, produced by
    # tools/import_timm_weights.py. The reference always starts from timm
    # pretrained weights (ref: model/model.py:37-46); here provenance is
    # explicit: empty -> random init, path -> overlay onto 'features'.
    backbone_ckpt: str = ""
    dtype: str = "bfloat16"  # compute dtype; params stay float32
    data_axis: str = "data"  # mesh axis name for data parallelism
    checkpoint_backbone: bool = False  # jax.checkpoint the backbone (remat)
    fuse_entry: bool = False  # fused custom-VJP entry blocks (kernels/fused_block.py)
    fuse_shift: bool = False  # fused stride-2 shift blocks (s3_b1/s4_b1)
    pallas_augment: Optional[bool] = None  # fused photometric kernel (None=auto)
    decoder: str = "auto"  # 'auto' | 'native' | 'pil' | 'cv2'
    # Decoded-frame LRU budget (MiB/host, 0 = off). Clips resample from a
    # FIXED stored plan with ~90% window overlap (ref: dataset/frame.py:
    # 116,210-241), so hot frames repeat; caching decoded pixels cuts the
    # host decode-core budget by the hit rate (docs/DESIGN.md).
    decode_cache_mb: int = 1024

    def __post_init__(self) -> None:
        if isinstance(self.crop_dim, int) and self.crop_dim <= 0:
            # ref: train_tdeed.py:110-111
            self.crop_dim = None
        assert self.store_mode in ("store", "load"), self.store_mode
        assert self.criterion in ("map", "loss"), self.criterion
        assert self.modality == "rgb", "Only RGB supported (ref: model/model.py:28)"
        assert self.batch_size % self.acc_grad_iter == 0  # ref: train_tdeed.py:109

    # Derived quantities -------------------------------------------------
    @property
    def num_classes_bg(self) -> int:
        """Classes including background slot 0 (ref: model/model.py:191)."""
        return self.num_classes + 1

    @property
    def backbone(self) -> str:
        return self.feature_arch.rsplit("_", 1)[0]

    @property
    def shift_mode(self) -> Optional[str]:
        if self.feature_arch.endswith("_gsm"):
            return "gsm"
        if self.feature_arch.endswith("_gsf"):
            return "gsf"
        return None

    @property
    def dataset_len(self) -> int:
        """Virtual epoch length in clips (ref: dataset/datasets.py:22)."""
        return self.epoch_num_frames // self.clip_len

    @property
    def micro_batch_size(self) -> int:
        return self.batch_size // self.acc_grad_iter

    # Serialization ------------------------------------------------------
    @classmethod
    def from_dict(cls, d: Dict[str, Any], **overrides: Any) -> "TDEEDConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs: Dict[str, Any] = {}
        for k, v in d.items():
            if k not in known:
                continue
            if k == "pretrain" and v is not None:
                v = PretrainConfig.from_dict(v)
            kwargs[k] = v
        kwargs.update(overrides)
        return cls(**kwargs)

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        return d


def config_path_for_model(config_root: str, model: str) -> str:
    """Resolve ``<root>/<Prefix>/<model>.json`` (ref: train_tdeed.py:98-99)."""
    prefix = model.split("_")[0]
    return os.path.join(config_root, prefix, model + ".json")


def load_config(
    model: str,
    config_root: str = "configs",
    **overrides: Any,
) -> TDEEDConfig:
    """Load a model config by name, reference-style.

    ``save_dir`` gets the model name appended (ref: train_tdeed.py:48).
    """
    path = model if model.endswith(".json") else config_path_for_model(config_root, model)
    with open(path) as fp:
        raw = json.load(fp)
    cfg = TDEEDConfig.from_dict(raw, model=os.path.basename(path)[: -len(".json")], **overrides)
    if cfg.save_dir:
        cfg.save_dir = os.path.join(cfg.save_dir, cfg.model)
    return cfg
