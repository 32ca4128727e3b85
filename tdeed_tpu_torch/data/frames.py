"""Frame decoding: JPEG -> (H, W, 3) uint8 numpy, NHWC from the start.

The port's own copy of ``get_decoder``, ``load_clip`` and ``load_window``
from ``tdeed_tpu/data/frames.py`` (held equal by
tests/test_torch_infer_copies.py, tests/test_torch_train_copies.py and
tests/test_torch_frames_native.py). Backends, in preference order:
  * 'native' — the port's C++ libjpeg batch decoder (native/jpeg.py,
    built with g++ at first use), releases the GIL, C++ threads per clip;
  * 'cv2'    — OpenCV imread (libjpeg-turbo under the hood, releases GIL);
  * 'pil'    — Pillow fallback.
'auto' takes the first that works; 'native' asked for by name raises with
the compiler's message when the decoder did not build (the JAX function
falls back to PIL there).

The reference decodes with torchvision.io.read_image into CHW uint8
(ref: dataset/frame.py:270-272); we decode straight to HWC, the layout the
model's preprocessing consumes, so no host-side transpose ever happens.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

import numpy as np

from tdeed_tpu_torch.native import jpeg as native_jpeg

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
    if kind in ("auto", "native"):
        if native_jpeg.available():
            return native_jpeg.decode
        if kind == "native":
            raise RuntimeError(native_jpeg.error())
    if kind in ("auto", "cv2"):
        try:
            _get_cv2()
            return _decode_cv2
        except Exception:
            if kind == "cv2":
                raise
    return _decode_pil


def _batch_native(decoder) -> bool:
    """Whether a clip goes through the C++ batch decoder: the caller chose
    the native decoder (or none) and it is built."""
    return (decoder is None or decoder is native_jpeg.decode) and native_jpeg.available()


def _clip_frame_paths(paths: list, stride: int, pad: bool) -> List[Optional[str]]:
    """Expand a stored clip record into per-slot file paths (None = pad)."""
    base_path, start, pad_start, pad_end, ndigits, length = paths
    n_real = length - pad_start - pad_end
    out: List[Optional[str]] = [None] * pad_start
    for j in range(n_real):
        idx = start + j * stride
        if ndigits > 0:
            out.append(os.path.join(base_path, str(idx).zfill(ndigits) + ".jpg"))
        else:
            out.append(os.path.join(base_path, f"frame{idx}.jpg"))
    if pad:
        out.extend([None] * pad_end)
    return out


def load_clip(
    paths: list,
    stride: int,
    decoder: Callable[[str], np.ndarray],
    pad: bool = True,
    cache=None,
) -> np.ndarray:
    """Decode a stored clip record into (T, H, W, 3) uint8.

    paths = [base_path, found_start, pad_start, pad_end, ndigits, length]
    (the reference pickle format; ref: dataset/frame.py:355-382). Start is
    always zero-padded; end only when pad=True.

    Fast path: when the caller chose the native decoder, the whole clip
    decodes with C++ threads into one contiguous buffer (no per-frame
    Python overhead).

    cache: optional ``tdeed_tpu_torch.data.loader.FrameCache`` — decoded
    frames are served from / inserted into the LRU; only misses decode.
    Falls back to the uncached path on any inconsistency (mid-clip
    resolution change, corrupt frame), so behavior is bit-identical with
    or without a cache.
    """
    slot_paths = _clip_frame_paths(paths, stride, pad)
    first_real = next((p for p in slot_paths if p is not None), None)
    assert first_real is not None, paths

    if cache is not None:
        out = _load_clip_cached(slot_paths, decoder, cache)
        if out is not None:
            return out

    # The C++ batch path only when the caller actually selected the native
    # decoder: an explicit cfg.decoder='cv2'/'pil' must be honored
    # (different libjpeg backends give different IDCT pixels).
    if _batch_native(decoder):
        try:
            h, w = native_jpeg.probe(first_real)
        except OSError:
            pass  # the per-frame decoder below raises the proper error
        else:
            arr, n_ok = native_jpeg.decode_batch(slot_paths, h, w)
            if n_ok == sum(1 for p in slot_paths if p is not None):
                return arr
            # A present frame failed to decode (corrupt stream, or a
            # mid-clip resolution change vs the probed first frame): the
            # C++ path zero-fills it silently, indistinguishable from
            # padding — fall through to the per-frame decoder, which
            # raises a proper error for the offending file.

    frames: List[np.ndarray] = []
    for p in slot_paths:
        if p is not None:
            frames.append(decoder(p))
    arr = np.stack(frames, axis=0)
    pad_start = paths[2]
    n_end = len(slot_paths) - pad_start - len(frames)
    if pad_start > 0 or n_end > 0:
        arr = np.pad(arr, ((pad_start, n_end), (0, 0), (0, 0), (0, 0)))
    return arr


def _load_clip_cached(
    slot_paths: List[Optional[str]],
    decoder: Callable[[str], np.ndarray],
    cache,
) -> Optional[np.ndarray]:
    """Assemble a clip from the decoded-frame LRU, decoding only misses.

    Returns None to make the caller fall back to the uncached path (shape
    inconsistency or a decode failure, where the per-frame decoder raises
    the proper error). Output rows are always freshly allocated or copied —
    the returned clip never aliases cache storage.
    """
    hits = [cache.get(p) if p is not None else None for p in slot_paths]
    miss = [
        p if (p is not None and h is None) else None
        for p, h in zip(slot_paths, hits)
    ]
    n_miss = sum(1 for p in miss if p is not None)
    shape = next((h.shape for h in hits if h is not None), None)
    if any(h is not None and h.shape != shape for h in hits):
        return None

    n = len(slot_paths)
    # Same contract as the uncached fast path: C++ batch decode only when
    # the caller actually selected the native decoder.
    if n_miss > 0 and _batch_native(decoder):
        first_miss = next(p for p in miss if p is not None)
        try:
            h, w = native_jpeg.probe(first_miss)
        except OSError:
            return None
        if shape is None:
            shape = (h, w, 3)
        elif shape != (h, w, 3):
            return None
        # decode_batch zero-fills masked (None) slots, so the misses land
        # directly in their final clip slots; hits are copied over after.
        arr, n_ok = native_jpeg.decode_batch(miss, h, w)
        if n_ok != n_miss:
            return None
        for i, (p, hit) in enumerate(zip(slot_paths, hits)):
            if hit is not None:
                arr[i] = hit
            elif p is not None:
                cache.put(p, arr[i].copy())
        return arr

    decoded = {}
    for p in miss:
        if p is None:
            continue
        try:
            d = decoder(p)
        except Exception:
            return None
        if shape is None:
            shape = d.shape
        elif d.shape != shape:
            return None
        decoded[p] = d
    if shape is None:
        return None  # all-pad clip: let the uncached path handle it
    out = np.zeros((n,) + tuple(shape), np.uint8)
    for i, (p, hit) in enumerate(zip(slot_paths, hits)):
        if hit is not None:
            out[i] = hit
        elif p is not None:
            out[i] = decoded[p]
            cache.put(p, decoded[p])
    return out


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
