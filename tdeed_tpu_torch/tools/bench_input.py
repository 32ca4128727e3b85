"""Host input-pipeline throughput (port of tools/bench_input.py).

    python -m tdeed_tpu_torch.tools.bench_input [--geom flagship|snb] [--frames 400] \\
        [--batches 6] [--target FRAMES_PER_S]

On a synthetic JPEG tree (``measure.synth_tree``: the JAX tool's textured
frames, quality 85), it measures:

  1. each decoder alone on one thread: the native libjpeg decoder
     (native/jpeg.py), OpenCV and Pillow;
  2. the native batch decoder on its own C++ threads (``decode_batch``);
  3. the training input path (``measure.bench_pipeline``): the port's ClipSampler
     and BatchLoader (threaded decode, collate, bounded prefetch), in
     frames/s, with and without the mixup stream, cold and through the
     FrameCache at steady state, with its hit rate;
  4. with ``--target`` (a training rate in frames/s the host must feed),
     the cores that rate needs at the measured frames/s per core. There is
     no default: the JAX tool's 10,375 was a TPU's rate. The port's bench
     (tdeed_tpu_torch.tools.bench) computes the cores for the flagship
     rate it measured.

Host work only: no device is used. Every decoder must be there; the
native one must build (its error is raised, not skipped). Prints one JSON
line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, Optional, Sequence

from tdeed_tpu_torch.tools.measure import CACHE_MB, bench_pipeline, cores_to_feed, synth_tree

GEOMS = {
    # stored-frame geometry: (width, height, clip_len, batch)
    "flagship": (256, 256, 100, 8),  # FineDiving_small class (crop 224)
    "snb": (796, 448, 100, 4),  # SNB challenge full frames (ref: extract_frames_snb.py:22-23)
}


def bench_decoders(vdir: str, n: int, w: int, h: int) -> Dict[str, float]:
    """Frames/s of each decoder on one thread over the first ``n`` frames,
    and of ``decode_batch`` on the native decoder's threads."""
    from tdeed_tpu_torch.data import frames as F
    from tdeed_tpu_torch.native import jpeg as native_jpeg

    if not native_jpeg.available():
        raise RuntimeError(f"bench_input: the native decoder did not build: "
                           f"{native_jpeg.error()}")
    F._get_cv2()  # raises ImportError where OpenCV is missing
    paths = [os.path.join(vdir, f"{i + 1:04d}.jpg") for i in range(n)]
    out = {}
    for name, dec in (("native", native_jpeg.decode), ("cv2", F._decode_cv2),
                      ("pil", F._decode_pil)):
        dec(paths[0])  # warm (imports, caches)
        t0 = time.perf_counter()
        for path in paths:
            a = dec(path)
        dt = time.perf_counter() - t0
        if a.shape != (h, w, 3):
            raise ValueError(f"bench_input: {name} decoded {a.shape}, not {(h, w, 3)}")
        out[f"decode_{name}_fps_1thread"] = n / dt

    native_jpeg.decode_batch(paths[:8], h, w)  # warm
    t0 = time.perf_counter()
    _, n_ok = native_jpeg.decode_batch(paths, h, w)
    dt = time.perf_counter() - t0
    if n_ok != n:
        raise RuntimeError(f"bench_input: decode_batch decoded {n_ok} of {n} frames")
    out["decode_native_batch_fps"] = n / dt
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--geom", choices=sorted(GEOMS), default="flagship")
    p.add_argument("--frames", type=int, default=400,
                   help="synthetic frames to write (decode set size)")
    p.add_argument("--batches", type=int, default=6)
    p.add_argument("--target", type=float, default=None,
                   help="training frames/s the host must feed; without it the "
                        "cores_to_feed rows are left out")
    args = p.parse_args(argv)

    w, h, clip_len, batch = GEOMS[args.geom]
    cores = os.cpu_count() or 1
    res = {"tool": "bench_input", "platform": "cpu", "geom": args.geom, "width": w,
           "height": h, "clip_len": clip_len, "batch": batch, "cores": cores}

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        vdir = synth_tree(root, args.frames, w, h)
        res["synth_sec"] = time.perf_counter() - t0
        res.update(bench_decoders(vdir, min(args.frames, 200), w, h))
        for key, mixup, cache_mb in (("pipeline_fps", False, 0),
                                     ("pipeline_fps_mixup", True, 0),
                                     ("pipeline_fps_cached", False, CACHE_MB),
                                     ("pipeline_fps_mixup_cached", True, CACHE_MB)):
            run = bench_pipeline(vdir, args.frames, clip_len, batch, args.batches, mixup,
                                 cache_mb=cache_mb)
            res[key] = run["fps"]
            if cache_mb:
                res["cache_hit_rate" + ("_mixup" if mixup else "")] = run["hit_rate"]

    res["pipeline_fps_per_core"] = res["pipeline_fps"] / cores
    if args.target is not None:
        # mixup decodes 2 clips per trained clip without the cache
        res["target_fps"] = args.target
        res["cores_to_feed_target"] = cores_to_feed(args.target, res["pipeline_fps"], cores, 2)
        res["cores_to_feed_target_cached"] = cores_to_feed(
            args.target, res["pipeline_fps_mixup_cached"], cores)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
