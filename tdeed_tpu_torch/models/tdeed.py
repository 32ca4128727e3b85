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

from typing import Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from tdeed_tpu_torch.models.heads import FC2Layers, FCLayers
from tdeed_tpu_torch.models.regnet import ARCH_PARAMS, RegNetY
from tdeed_tpu_torch.models.sgp import EDSGPMixer

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class TDEED(nn.Module):
    """Precise-event-spotting model.

    forward(frames, dropout_keep=None) takes standardized frames
    (B, T, H, W, 3) and returns a dict with
      'logits': (B, T, num_classes + 1) fp32, or with ``two_heads`` =
                (C1+1, C2+1) the two heads' logits concatenated,
                (B, T, C1+1 + C2+1) (ref: model/modules.py:378-387)
      'displ':  (B, T) fp32 when radi_displacement > 0.
    The trunk is RegNet-Y ``arch`` with ``shift_mode`` ('gsm', 'gsf' or
    None for the plain trunk) in s3/s4; ``checkpoint_backbone`` recomputes
    its activations in the backward pass (models/regnet.py).
    Train/eval mode is the module's (``.train()`` / ``.eval()``): it picks
    batch or running BN statistics. ``dropout_keep`` maps the names in
    ``dropout_heads`` ('pred_fine', or 'pred_fine.fc1' and 'pred_fine.fc2'
    with two heads; 'pred_displ') to boolean (B, T, D) keep masks; without
    it the heads apply no dropout.
    """

    def __init__(self, num_classes: int, clip_len: int, n_layers: int = 2,
                 sgp_ks: int = 7, sgp_r: float = 4.0,
                 radi_displacement: int = 2, dtype=torch.bfloat16,
                 arch: str = "rny002",
                 two_heads: Optional[Sequence[int]] = None,
                 shift_mode: Optional[str] = "gsf",
                 checkpoint_backbone: bool = False):
        super().__init__()
        self.clip_len = clip_len
        self.dtype = dtype
        self.two_heads = None if two_heads is None else tuple(two_heads)
        self._features = RegNetY(arch, clip_len=clip_len, shift_mode=shift_mode,
                                 checkpoint_blocks=checkpoint_backbone)
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
        if self.two_heads is None:
            self._pred_fine = FCLayers(d, num_classes + 1)
        else:
            self._pred_fine = FC2Layers(d, self.two_heads)

    @property
    def dropout_heads(self) -> List[str]:
        """The names ``dropout_keep`` takes a mask under, in draw order."""
        fine = (["pred_fine"] if self.two_heads is None
                else ["pred_fine.fc1", "pred_fine.fc2"])
        return fine + (["pred_displ"] if self._pred_displ is not None else [])

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
        if self.two_heads is None:
            logits = self._pred_fine(feat, keep.get("pred_fine"))
        else:
            logits = self._pred_fine(
                feat, keep.get("pred_fine.fc1"), keep.get("pred_fine.fc2")
            )
        out["logits"] = logits.float()
        return out


def refuse(what: str, item: str) -> None:
    """Raise NotImplementedError for a feature the port does not carry,
    naming the ROADMAP.md item that brings it."""
    raise NotImplementedError(
        f"{what} is not in tdeed_tpu_torch (ROADMAP.md, port queue: {item})"
    )


def check_supported(cfg) -> None:
    """Raise NotImplementedError for config values the port does not carry,
    ValueError for a feature_arch the JAX package cannot build either."""
    if cfg.backbone not in ARCH_PARAMS:
        # parsed as the JAX package parses it (tdeed_tpu/models/tdeed.py:49-54)
        raise ValueError(
            f"feature_arch {cfg.feature_arch!r}: the trunk {cfg.backbone!r} is not one of "
            f"{sorted(ARCH_PARAMS)} (an optional _gsm or _gsf suffix adds the shift)"
        )
    if cfg.fuse_entry or getattr(cfg, "fuse_shift", False):
        refuse("fuse_entry/fuse_shift", "not to port: the fused_block custom-VJP family")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {cfg.dtype!r}")


def build_model(cfg, two_heads=None, *, device="cuda") -> TDEED:
    """Construct a TDEED module from a TDEEDConfig (tdeed_tpu_torch.config)
    on ``device``: the CUDA device unless the caller asks for the CPU.
    ``two_heads`` = (C1+1, C2+1) builds the FC2 double head of joint
    pretraining (``two_heads_for``).

    Weights are drawn from torch's default CPU generator and then moved,
    so one seed gives the same weights on every device. Without a CUDA
    device, ``device="cuda"`` raises RuntimeError: nothing falls back to
    the CPU."""
    check_supported(cfg)
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
        arch=cfg.backbone,
        two_heads=two_heads,
        shift_mode=cfg.shift_mode,
        checkpoint_backbone=cfg.checkpoint_backbone,
    ).to(device)


def two_heads_for(cfg):
    """(C1+1, C2+1), each head's classes with its background, for a config
    with joint pretraining; None without (ref: model/model.py:169-172)."""
    if cfg.pretrain is None:
        return None
    return (cfg.num_classes + 1, cfg.pretrain.num_classes + 1)
