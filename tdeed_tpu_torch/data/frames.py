"""Frame decoding: JPEG -> (H, W, 3) uint8 numpy, NHWC from the start.

The port's own copy of ``get_decoder`` and ``load_window`` from
``tdeed_tpu/data/frames.py`` (held equal by
tests/test_torch_infer_copies.py). Backends, in preference order:
  * 'cv2' — OpenCV imread (libjpeg-turbo under the hood, releases the GIL);
  * 'pil' — Pillow fallback.
The JAX package's first-party C++ decoder ('native') has no copy here yet:
``get_decoder('native')`` refuses, and 'auto' falls through to cv2, then
PIL, as the JAX function does when the native library is missing.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np

from tdeed_tpu_torch.models.tdeed import refuse

_cv2 = None


def _get_cv2():
    global _cv2
    if _cv2 is None:
        import cv2

        _cv2 = cv2
    return _cv2


def _decode_cv2(path: str) -> np.ndarray:
    cv2 = _get_cv2()
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img[:, :, ::-1]  # BGR -> RGB


def _decode_pil(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def get_decoder(kind: str = "auto") -> Callable[[str], np.ndarray]:
    if kind == "native":
        refuse("decoder='native' (the C++ libjpeg batch decoder)", "checkpoint and the CLIs")
    if kind in ("auto", "cv2"):
        try:
            _get_cv2()
            return _decode_cv2
        except Exception:
            if kind == "cv2":
                raise
    return _decode_pil


def load_window(
    spec,
    frame_dir: str,
    video: str,
    start: int,
    end: int,
    stride: int,
    decoder: Callable[[str], np.ndarray],
    pad: bool = True,
    source_info: Optional[dict] = None,
    cache=None,
) -> Optional[np.ndarray]:
    """Eval-time window read with missing-frame end padding
    (ref: dataset/frame.py:558-626). Returns None if no frame decoded.

    cache: optional FrameCache — eval windows overlap 75%
    (spec.eval_overlap_len), so consecutive windows re-decode most frames;
    the LRU serves the repeats from memory. np.stack below always copies,
    so the returned window never aliases cache storage."""
    path, frame0, ndigits = spec.scheme.resolve(frame_dir, video, source_info)
    frames: List[np.ndarray] = []
    n_pad_start = 0
    n_pad_end = 0
    for frame_num in range(start, end, stride):
        if frame_num < 0:
            n_pad_start += 1
            continue
        idx = frame0 + frame_num
        if ndigits > 0:
            fp = os.path.join(path, str(idx).zfill(ndigits) + ".jpg")
        else:
            fp = os.path.join(path, f"frame{idx}.jpg")
        if cache is not None:
            hit = cache.get(fp)
            if hit is not None:
                frames.append(hit)
                continue
        try:
            decoded = decoder(fp)
        except (FileNotFoundError, OSError):
            n_pad_end += 1
            continue
        if cache is not None:
            cache.put(fp, decoded)
        frames.append(decoded)
    if not frames:
        return None
    arr = np.stack(frames, axis=0)
    if n_pad_start > 0 or (pad and n_pad_end > 0):
        arr = np.pad(
            arr, ((n_pad_start, n_pad_end if pad else 0), (0, 0), (0, 0), (0, 0))
        )
    return arr
