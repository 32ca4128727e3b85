"""Persistent inference engine: load once, spot events in many videos
(port of tdeed_tpu/infer/predictor.py).

A ``SpottingPredictor`` holds the model on its device and the predict step;
``spot()`` runs sliding-window inference over one video's frame directory
and returns NMS'd events, so a long-lived process (batch job, RPC wrapper,
notebook) builds the model once. The window enumeration, the batch-1 rule
under TTA, thresholding and the NMS/SNMS selection are the JAX class's.

Scores are aggregated over overlapping windows by one of two paths, as in
the JAX class: the host loop ``infer.evaluate.predict_windows``
(``device_aggregate=False``), or per-video buffers on the model's device
that the host reads once, at the end of the video (``_spot_device``, the
default). Both add each window's scores in window order, so they give the
same bits, and two calls give the same bits.

With ``n_devices`` N > 1 the predictor keeps a replica of the model on
each of N devices (cuda:0..N-1, or N times the CPU) and splits every
window batch into N equal slices, run together and gathered in window
order on the first device (parallel/mesh.py, the counterpart of the JAX
class's sharded predict). The window batch rounds up to a multiple of N,
and under the TTA it is N windows, one a device, in place of 1. Eval rows
are independent, so the scores are one device's, bit for bit, wherever a
slice's shape on a replica gives its rows the same arithmetic as on one
device.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tdeed_tpu_torch.config import load_config
from tdeed_tpu_torch.data import frames as frame_io
from tdeed_tpu_torch.data.frames import load_window
from tdeed_tpu_torch.data.loader import FrameCache
from tdeed_tpu_torch.data.registry import DEFAULT_PAD_LEN, FPS_SN, get_spec, load_classes
from tdeed_tpu_torch.infer.evaluate import INFERENCE_BATCH_SIZE, predict_windows
from tdeed_tpu_torch.infer.nms import (
    non_maximum_suppression,
    soft_non_maximum_suppression,
)
from tdeed_tpu_torch.models.tdeed import build_model, two_heads_for
from tdeed_tpu_torch.parallel import mesh
from tdeed_tpu_torch.train.step import make_predict_step
from tdeed_tpu_torch.utils.jax_convert import params_from_jax


def restore_run(model_name: str, config_root: str = "configs", data_root: str = "data"):
    """(cfg, state_dict, classes, two_heads) of a finished run of the
    port's training CLI: its config, its best checkpoint (on the CPU), the
    dataset's class map, and the double head's sizes for a config with
    ``pretrain`` (else None)."""
    from tdeed_tpu_torch.checkpoint import CheckpointManager

    cfg = load_config(model_name, config_root)
    classes = load_classes(os.path.join(data_root, cfg.dataset, "class.txt"))
    ckpt = CheckpointManager(cfg.save_dir or os.path.join("checkpoints", cfg.model))
    return cfg, ckpt.restore_best(), classes, two_heads_for(cfg)


class _PinnedStager:
    """Host-to-device copies of window batches through two pinned host
    buffers, used in turn.

    A copy from pageable numpy memory is synchronous: the 78 MB of a 4-clip
    request were 42% of predict's device time (PERF.md §5). From pinned
    memory the copy is only enqueued, and the host goes on decoding the
    next batch while the device works; this is the port's form of the JAX
    path's asynchronous dispatch. Each copy records a CUDA event, and a
    buffer is refilled only once the event of its last copy has passed, so
    a batch never overwrites memory a copy is still reading. On the CPU the
    batch is used as it is.
    """

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: List[Optional[torch.Tensor]] = [None, None]
        self._copied: List[Optional[torch.cuda.Event]] = [None, None]
        self._turn = 0

    def __call__(self, frames: np.ndarray) -> torch.Tensor:
        src = torch.from_numpy(frames)
        if self.device.type != "cuda":
            return src
        i, self._turn = self._turn, 1 - self._turn
        if self._copied[i] is not None:
            self._copied[i].synchronize()
        buf = self._bufs[i]
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = self._bufs[i] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        out = buf.to(self.device, non_blocking=True)
        self._copied[i] = torch.cuda.Event()
        self._copied[i].record(torch.cuda.current_stream(self.device))
        return out


class SpottingPredictor:
    """Event spotting over frame directories with a persistent model.

    Args:
      cfg: TDEEDConfig (tdeed_tpu_torch.config), or use ``from_run`` to
        load config + best checkpoint.
      state_dict: the model's weights, as ``TDEED.state_dict()`` names them
        (``from_jax_params`` takes the JAX package's trees instead).
      classes: {name: id} with ids 1..N (0 = background).
      batch_size: windows per predict call without TTA (with TTA, 1),
        rounded up to a multiple of ``n_devices``.
      device: where the model runs; the CUDA device unless the caller asks
        for the CPU. Without a card, "cuda" raises RuntimeError.
      two_heads: (C1+1, C2+1) for a model trained with the FC2 double
        head; events come from head 1 alone, whose classes ``classes``
        names.
      n_devices: replicas to split each window batch over: cuda:0..N-1
        (more than the machine's cards raises), or N on the CPU.
    """

    def __init__(self, cfg, state_dict, classes: Dict[str, int], *,
                 batch_size: int = INFERENCE_BATCH_SIZE, device="cuda",
                 two_heads=None, n_devices: Optional[int] = None):
        self.devices = mesh.serving_devices(device, n_devices)
        n = len(self.devices)
        batch_size = -(-batch_size // n) * n
        self.cfg = cfg
        self.spec = get_spec(cfg.dataset)
        self.classes = classes
        self.classes_inv = {v: k for k, v in classes.items()}
        self.batch_size = batch_size
        # looked up through the module, so a caller can put another reader
        # in its place (a machine without cv2 or PIL)
        self.decoder = frame_io.get_decoder(cfg.decoder)
        # Decoded-frame LRU: serving windows overlap ~75%
        # (spec.eval_overlap_len), so the cache serves most repeat decodes
        # from memory (cfg.decode_cache_mb, 0 = off).
        self._cache = None
        if getattr(cfg, "decode_cache_mb", 0) > 0:
            self._cache = FrameCache(cfg.decode_cache_mb << 20)
        self.model = build_model(cfg, two_heads, device=self.devices[0])
        self.model.load_state_dict(state_dict, strict=True)
        self.model.eval()
        self.device = next(self.model.parameters()).device
        self._predicts = [
            make_predict_step(m, crop_dim=cfg.crop_dim, radi_displacement=cfg.radi_displacement)
            for m in mesh.replicate(self.model, self.devices)
        ]
        self._stages = [_PinnedStager(d) for d in self.devices]

    # -- construction -----------------------------------------------------

    @classmethod
    def from_jax_params(cls, cfg, params, batch_stats, classes: Dict[str, int],
                        **kw) -> "SpottingPredictor":
        """Build from the JAX package's {params, batch_stats} trees (numpy
        or JAX arrays), carried across by utils.jax_convert.params_from_jax."""
        return cls(cfg, params_from_jax(params, batch_stats), classes, **kw)

    @classmethod
    def from_run(cls, model_name: str, config_root: str = "configs",
                 data_root: str = "data", **kw) -> "SpottingPredictor":
        """Load config + class map + best checkpoint of a finished run of
        the port's training CLI (cli/train.py), on ``device`` ("cuda"
        unless the caller passes ``device="cpu"``); a config with
        ``pretrain`` builds the double head and spots with head 1."""
        cfg, state_dict, classes, two_heads = restore_run(model_name, config_root, data_root)
        return cls(cfg, state_dict, classes, two_heads=two_heads, **kw)

    # -- inference --------------------------------------------------------

    def predict_fn(self, frames: np.ndarray, hflip: bool) -> torch.Tensor:
        """Scores (B, T, C+1) fp32 on the model's device for a
        (B, T, H, W, 3) uint8 window batch, staged through the pinned
        buffers: the ``predict_fn`` of ``infer.evaluate.evaluate``. B must
        be a multiple of ``n_devices``."""
        return self._scores(self._stage(frames), hflip)

    def _stage(self, frames: np.ndarray) -> List[torch.Tensor]:
        """The batch's slices, one a replica, each on its device."""
        bounds = mesh.shard_bounds(len(frames), len(self.devices))
        return [stage(frames[a:b]) for stage, (a, b) in zip(self._stages, bounds)]

    def _scores(self, parts: List[torch.Tensor], hflip: bool) -> torch.Tensor:
        """Each replica's scores of its slice, all launched before any is
        read, gathered in order on the first device."""
        return mesh.gather([p(x, hflip)[1] for p, x in zip(self._predicts, parts)],
                           self.device)

    def _spot_device(self, batches, t_len: int, bs: int, tta: bool):
        """Aggregate one video's windows on the model's device; the host
        reads the buffers once, at the end.

        The buffers carry clip_len slack at both ends, so the reference's
        bound clamping (ref: util/eval.py:303-317) becomes plain in-bounds
        slices: windows start at >= -pad_len and overrun the tail by
        < clip_len. The JAX class rounds the buffer length up to 512-row
        buckets so that videos of similar length share one XLA executable;
        eager PyTorch compiles nothing, so here it is exact.

        A ragged last batch is zero-padded to ``bs`` as in predict_windows,
        so the model sees the host path's shapes, and only its ``n`` valid
        windows are added: the padded rows are what the JAX program's valid
        mask zeroes. Each window's slice is added on its own, in window
        order, and under the TTA a window's two passes one after the
        other, so the sums do not depend on how many windows a batch
        holds: N replicas (batch N under the TTA) add what one device
        (batch 1) adds. The host loop adds a batch's passes in turn, the
        same order at batch 1. Rows of one batch overlap (by 3/4 of a
        window), and ``index_add_``/``scatter_add_`` on CUDA add them with
        atomics in an order that changes from run to run; in window order
        the fp32 sums are the host loop's, bit for bit. Support: under TTA each pass
        counts every row; otherwise only rows with a nonzero summed score
        (the displacement decode leaves unclaimed rows zero).
        """
        clip_len = self.cfg.clip_len
        n_cls = len(self.classes) + 1
        buf_len = t_len + 2 * clip_len
        scores_buf = torch.zeros((buf_len, n_cls), dtype=torch.float32, device=self.device)
        support_buf = torch.zeros(buf_len, dtype=torch.int32, device=self.device)
        passes = [False, True] if tta else [False]
        for batch in batches:
            frames = np.stack([c["frame"] for c in batch], axis=0)
            n = len(batch)
            if n < bs:
                frames = np.concatenate(
                    [frames,
                     np.zeros((bs - n, *frames.shape[1:]), frames.dtype)],
                    axis=0,
                )
            x = self._stage(frames)
            outs = []
            for hflip in passes:
                probs = self._scores(x, hflip).float()
                outs.append((probs, None if tta else (probs[:n].sum(dim=2) != 0).int()))
            for i, clip in enumerate(batch):
                start = int(clip["start"]) + clip_len  # slack offset
                for probs, rows in outs:
                    scores_buf[start:start + clip_len] += probs[i]
                    support_buf[start:start + clip_len] += 1 if rows is None else rows[i]
        scores = scores_buf[clip_len:clip_len + t_len].cpu().numpy()
        support = support_buf[clip_len:clip_len + t_len].cpu().numpy()
        return scores, support

    def _windows(self, num_frames: int) -> List[int]:
        stride = self.spec.eval_stride
        clip_len = self.cfg.clip_len
        overlap = self.spec.eval_overlap_len(clip_len)
        hop = (clip_len - overlap) * stride
        # same enumeration as VideoWindows (ref: dataset/frame.py:409-423)
        return list(
            range(-DEFAULT_PAD_LEN * stride,
                  max(0, num_frames - overlap * stride), hop)
        )

    def spot(
        self,
        frame_dir: str,
        video: str,
        num_frames: Optional[int] = None,
        source_info: Optional[dict] = None,
        nms: str = "snms",  # 'nms' | 'snms' | 'none'
        threshold: float = 0.01,
        hflip_tta: Optional[bool] = None,
        device_aggregate: bool = True,
    ) -> List[dict]:
        """Spot events in one video. Returns [{label, frame, score}, ...]
        with frames in *strided* units (multiply by spec.eval_stride for
        source frames)."""
        stride = self.spec.eval_stride
        clip_len = self.cfg.clip_len
        if num_frames is None:
            # Frame files are indexed in SOURCE-frame units (the extractor
            # renumbers to consecutive indices at the sampled fps), so the
            # file count IS num_frames — the data-layer stride applies on
            # top of it. Datasets whose videos share a frame directory
            # (tennis segments, finegym) cannot be counted this way.
            if self.cfg.dataset in ("tennis", "finegym"):
                raise ValueError(
                    f"{self.cfg.dataset} videos share frame directories; "
                    "pass num_frames explicitly (it is in the split JSON)"
                )
            path, frame0, nd = self.spec.scheme.resolve(
                frame_dir, video, source_info
            )
            num_frames = len(
                [f for f in os.listdir(path) if f.endswith(".jpg")]
            )
        if hflip_tta is None:
            hflip_tta = self.spec.hflip_tta

        t_len = math.ceil(num_frames / stride)
        starts = self._windows(num_frames)
        # TTA mirrors the reference's batch-1 protocol (ref: util/eval.py:32),
        # one window a device
        bs = len(self.devices) if hflip_tta else self.batch_size

        def batches():
            for ofs in range(0, len(starts), bs):
                out = []
                for s in starts[ofs : ofs + bs]:
                    f = load_window(
                        self.spec, frame_dir, video, s, s + clip_len * stride,
                        stride, self.decoder, pad=True,
                        source_info=source_info, cache=self._cache,
                    )
                    if f is None:
                        continue
                    out.append(
                        {"video": video, "start": s // stride, "frame": f}
                    )
                if out:
                    yield out

        if device_aggregate:
            scores, support = self._spot_device(batches(), t_len, bs,
                                                bool(hflip_tta))
        else:
            # host accumulation, same inner loop as evaluation
            pred_dict = {
                video: (
                    np.zeros((t_len, len(self.classes) + 1), np.float32),
                    np.zeros(t_len, np.int32),
                )
            }
            predict_windows(self.predict_fn, pred_dict, batches(), bs, hflip_tta)
            scores, support = pred_dict[video]
        support = support.copy()
        support[support == 0] = 1
        probs = scores / support[:, None]
        # vectorized event extraction (frame-major, class-ascending order,
        # same as the t/c loop it replaces)
        tt, cc = np.nonzero(probs[:, 1:] >= threshold)
        events = [
            {"label": self.classes_inv[int(c) + 1], "frame": int(t),
             "score": float(probs[t, c + 1])}
            for t, c in zip(tt, cc)
        ]
        pred = [{"video": video, "events": events,
                 "fps": FPS_SN / stride if self.spec.external_labels else None}]
        windows = self.spec.windows
        if nms == "nms":
            pred = non_maximum_suppression(pred, windows[0], threshold)
        elif nms == "snms":
            pred = soft_non_maximum_suppression(pred, windows[1], threshold)
        return pred[0]["events"]

    def spot_many(self, frame_dir: str, videos: Sequence[dict],
                  **kw) -> Dict[str, List[dict]]:
        """Spot events in many videos ({'video', 'num_frames', ...} metas)."""
        out = {}
        for meta in videos:
            out[meta["video"]] = self.spot(
                frame_dir, meta["video"], meta.get("num_frames"),
                meta.get("_source_info"), **kw,
            )
        return out
