"""T-DEED end-to-end module (port of tdeed_tpu/models/tdeed.py):
backbone + positional embedding + SGP U-Net + heads.

Parameter names are the reference T-DEED state_dict's (``_features``,
``temp_enc``, ``_temp_fine``, ``_pred_fine``, ``_pred_displ``;
ref: model/model.py:23-149), so a reference checkpoint loads with
``load_state_dict(strict=True)`` and the JAX package's
``convert_reference_state_dict`` maps this module's state_dict to its
trees.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn

from tdeed_tpu_torch.models.heads import FCLayers
from tdeed_tpu_torch.models.regnet import RegNetY
from tdeed_tpu_torch.models.sgp import EDSGPMixer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class TDEED(nn.Module):
    """Precise-event-spotting model.

    forward(frames, dropout_keep=None) takes standardized frames
    (B, T, H, W, 3) and returns a dict with
      'logits': (B, T, num_classes + 1) fp32
      'displ':  (B, T) fp32 when radi_displacement > 0.
    Train/eval mode is the module's (``.train()`` / ``.eval()``): it picks
    batch or running BN statistics. ``dropout_keep`` maps head names
    ('pred_fine', 'pred_displ') to boolean (B, T, D) keep masks; without
    it the heads apply no dropout.
    """

    def __init__(self, num_classes: int, clip_len: int, n_layers: int = 2,
                 sgp_ks: int = 7, sgp_r: float = 4.0,
                 radi_displacement: int = 2, dtype=torch.bfloat16):
        super().__init__()
        self.clip_len = clip_len
        self.dtype = dtype
        self._features = RegNetY("rny002", clip_len=clip_len)
        d = self._features.feat_dim
        self.feat_dim = d
        # N(0, 1/clip_len) additive temporal embedding (ref: model/model.py:65,137)
        self.temp_enc = nn.Parameter(torch.randn(clip_len, d) / clip_len)
        self._temp_fine = EDSGPMixer(
            d, clip_len, num_layers=n_layers, kernel_size=sgp_ks, k=sgp_r
        )
        self._pred_displ = (
            FCLayers(d, 1) if radi_displacement > 0 else None
        )
        self._pred_fine = FCLayers(d, num_classes + 1)

    def forward(
        self,
        frames: torch.Tensor,
        dropout_keep: Optional[Dict[str, torch.Tensor]] = None,
    ) -> Dict[str, torch.Tensor]:
        b, t, h, w, c = frames.shape
        if t != self.clip_len:
            raise ValueError(f"clip length {t} != model clip_len {self.clip_len}")
        keep = dropout_keep or {}
        # (B*T, 3, H, W) view in channels_last memory: no copy
        x = frames.reshape(b * t, h, w, c).permute(0, 3, 1, 2).to(self.dtype)
        feat = self._features(x).reshape(b, t, -1)
        feat = feat + self.temp_enc.to(feat.dtype)
        feat = self._temp_fine(feat)
        out = {}
        if self._pred_displ is not None:
            out["displ"] = self._pred_displ(
                feat, keep.get("pred_displ")
            )[..., 0].float()
        out["logits"] = self._pred_fine(feat, keep.get("pred_fine")).float()
        return out


def refuse(what: str, item: str) -> None:
    """Raise NotImplementedError for a feature the port does not carry,
    naming the ROADMAP.md item that brings it."""
    raise NotImplementedError(
        f"{what} is not in tdeed_tpu_torch (ROADMAP.md, port queue: {item})"
    )


def check_supported(cfg) -> None:
    """Raise NotImplementedError for config values the port does not carry."""
    arch = cfg.feature_arch
    if arch.startswith("rny008"):
        refuse(f"feature_arch {arch!r}", "rny008")
    if arch != "rny002_gsf":
        refuse(f"feature_arch {arch!r}", "GSM, then plain rny002")
    if cfg.fuse_entry or getattr(cfg, "fuse_shift", False):
        refuse("fuse_entry/fuse_shift", "not to port: the fused_block custom-VJP family")
    if cfg.checkpoint_backbone:
        refuse("checkpoint_backbone", "checkpoint and the CLIs (checkpoint_backbone)")
    if cfg.acc_grad_iter != 1:
        refuse(f"acc_grad_iter={cfg.acc_grad_iter}", "acc_grad_iter scan")
    if cfg.pretrain is not None:
        refuse("joint pretraining (two heads)", "FC2 double head")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {cfg.dtype!r}")


def build_model(cfg, two_heads=None, *, device="cuda") -> TDEED:
    """Construct a TDEED module from a TDEEDConfig (tdeed_tpu_torch.config)
    on ``device``: the CUDA device unless the caller asks for the CPU.

    Weights are drawn from torch's default CPU generator and then moved,
    so one seed gives the same weights on every device. Without a CUDA
    device, ``device="cuda"`` raises RuntimeError: nothing falls back to
    the CPU."""
    check_supported(cfg)
    if two_heads is not None:
        refuse("two_heads", "FC2 double head")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "build_model: no CUDA device (torch.cuda.is_available() is False); "
            "pass device='cpu' to build on the CPU"
        )
    return TDEED(
        num_classes=cfg.num_classes,
        clip_len=cfg.clip_len,
        n_layers=cfg.n_layers,
        sgp_ks=cfg.sgp_ks,
        sgp_r=cfg.sgp_r,
        radi_displacement=cfg.radi_displacement,
        dtype=_DTYPES[cfg.dtype],
    ).to(device)
