"""Offline video -> JPEG frame extraction (SoccerNet / SoccerNet-Ball / generic).

The port's own copy of ``tdeed_tpu/cli/extract_frames.py`` (held equal by
tests/test_torch_extract_frames.py); it imports no torch and nothing of the
JAX package. First-party equivalent of the reference extractors
(ref: extract_frames_sn.py, extract_frames_snb.py): OpenCV decode, resize to
796x448 for soccer broadcasts (ref: extract_frames_snb.py:22-23), temporal
sampling at ``--sample_fps`` (stride = src_fps / sample_fps), a
multiprocessing pool over videos, a per-video ``fps.txt`` sidecar consumed
by the data layer (ref: util/dataset.py:20-22), and the reference's
FPS-inconsistency repair: when the container frame count disagrees with
the decoded count beyond a threshold, frames are re-sampled at the
*effective* fps ``header_fps * decoded / header_count``
(ref: extract_frames_sn.py:86-99,148-178). Frames are written at JPEG
quality 95, the files the training and serving paths then read with the
native decoder (data/frames.py).

The decode and write path needs OpenCV (``cv2``, imported where a video
is opened); without it only the cv2-free parts (``find_videos``,
``output_name``, ``filter_by_game_list``) run. The tests drive the path
where cv2 is installed, and hold its stride and effective-fps arithmetic
against the JAX module's through a stand-in ``cv2`` module everywhere.

Game enumeration: ``--game_list data/<ds>/<split>.json`` restricts
extraction to the videos of a shipped split file — the offline equivalent
of the reference's ``SoccerNet.Downloader.getListGames`` call
(ref: extract_frames_sn.py:8,224), whose split lists are exactly the
shipped metadata.

Usage:
    python -m tdeed_tpu_torch.cli.extract_frames \
        --video_dir /path/videos --out_dir /path/frames \
        --sample_fps 25 [--game_list data/soccernetball/train.json]
        [--recalc_fps] [--num_workers N]
"""

from __future__ import annotations

import argparse
import os
from multiprocessing import Pool
from typing import List, Optional, Tuple

TARGET_HEIGHT = 448
TARGET_WIDTH = 796  # ref: extract_frames_snb.py:22-23
VIDEO_EXTS = (".mkv", ".mp4", ".avi", ".mov")
# Header-vs-decoded frame-count slack before the effective-fps repair kicks
# in (ref: extract_frames_sn.py FRAME_RETRY_THRESHOLD).
FRAME_RETRY_THRESHOLD = 100


def get_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--video_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--sample_fps", type=float, default=25.0)
    p.add_argument("--height", type=int, default=TARGET_HEIGHT)
    p.add_argument("--width", type=int, default=TARGET_WIDTH)
    p.add_argument("--no_resize", action="store_true")
    p.add_argument("--num_workers", type=int, default=os.cpu_count())
    p.add_argument(
        "--recalc_fps",
        action="store_true",
        help="verify container FPS by re-counting frames (slow but exact); "
             "mismatches beyond FRAME_RETRY_THRESHOLD trigger the "
             "effective-fps repair (ref: extract_frames_sn.py:86-99)",
    )
    p.add_argument(
        "--half_dirs", action="store_true",
        help="SoccerNet naming: map '<game>/1_720p.mkv' -> '<game>/half1/' "
             "frame dirs (ref: extract_frames_sn.py:204-209)",
    )
    p.add_argument(
        "--game_list",
        default=None,
        help="split JSON (data/<ds>/<split>.json): only extract videos whose "
             "game appears there (offline getListGames equivalent)",
    )
    return p.parse_args(argv)


def find_videos(video_dir: str) -> List[str]:
    """All video files below video_dir, as relative paths."""
    out = []
    for root, _, files in os.walk(video_dir):
        for f in sorted(files):
            if f.lower().endswith(VIDEO_EXTS):
                out.append(os.path.relpath(os.path.join(root, f), video_dir))
    return out


def recount_fps(path: str) -> Tuple[float, int]:
    """Exact fps by decoding the whole stream (frames / duration)."""
    import cv2

    vc = cv2.VideoCapture(path)
    n = 0
    while True:
        ok = vc.grab()
        if not ok:
            break
        n += 1
    msec = vc.get(cv2.CAP_PROP_POS_MSEC)
    vc.release()
    if msec <= 0:
        return 0.0, n
    return n / (msec / 1000.0), n


def output_name(video_rel: str, half_dirs: bool) -> str:
    """Relative output dir for a video; with half_dirs, SoccerNet halves
    '<game>/1_720p.mkv' become '<game>/half1' (ref: extract_frames_sn.py:204-209)."""
    import re

    name = os.path.splitext(video_rel)[0]
    if half_dirs:
        head, _, tail = name.rpartition("/")
        m = re.fullmatch(r"(\d+)(_720p)?", tail)
        if m:
            name = (head + "/" if head else "") + "half" + m.group(1)
    return name


def extract_one(task) -> Optional[dict]:
    """Extract one video. Returns {'video', 'num_frames', 'fps'} metadata."""
    (video_rel, video_dir, out_dir, sample_fps, size, recalc, half_dirs) = task
    import cv2

    src = os.path.join(video_dir, video_rel)
    name = output_name(video_rel, half_dirs)
    dst = os.path.join(out_dir, name)
    os.makedirs(dst, exist_ok=True)

    vc = cv2.VideoCapture(src)
    fps = vc.get(cv2.CAP_PROP_FPS)
    header_count = int(vc.get(cv2.CAP_PROP_FRAME_COUNT))
    effective_fps = fps
    if recalc:
        exact_fps, decoded = recount_fps(src)
        if (
            header_count > 0
            and header_count - decoded > FRAME_RETRY_THRESHOLD
        ):
            # Container metadata disagrees with the stream: some broadcast
            # videos carry a wrong header count/fps. Re-sample at the
            # effective rate (ref: extract_frames_sn.py:86-99).
            effective_fps = fps * decoded / header_count
            print(f"[{video_rel}] frame-count mismatch: header "
                  f"{header_count} vs decoded {decoded}; effective fps "
                  f"{effective_fps:.3f}")
        elif exact_fps > 0 and abs(exact_fps - fps) > 0.01:
            print(f"[{video_rel}] fps mismatch: header {fps:.3f} vs "
                  f"measured {exact_fps:.3f}; using measured")
            fps = effective_fps = exact_fps
    if fps <= 0:
        print(f"[{video_rel}] unreadable fps; skipping")
        vc.release()
        return None

    # stride in source frames between samples (ref: extract_frames_snb.py:64)
    stride = max(1.0, fps / sample_fps)
    out_fps = fps / stride

    def write(frame, i_out):
        if size is not None:
            frame = cv2.resize(frame, size, interpolation=cv2.INTER_AREA)
        cv2.imwrite(
            os.path.join(dst, f"frame{i_out}.jpg"),
            frame,
            [cv2.IMWRITE_JPEG_QUALITY, 95],
        )

    i_src = 0
    i_out = 0
    if effective_fps == fps:
        next_sample = 0.0
        while True:
            ok, frame = vc.read()
            if not ok:
                break
            if i_src >= next_sample:
                next_sample += stride
                write(frame, i_out)
                i_out += 1
            i_src += 1
    else:
        # Repair path: walk decoded frames on the effective-fps clock so
        # output timestamps stay aligned with the annotations
        # (ref: extract_frames_sn.py:148-178 "strange framerate" branch).
        next_out = 0.0
        while True:
            ok, frame = vc.read()
            if not ok:
                break
            if i_src * fps / effective_fps >= next_out:
                write(frame, i_out)
                i_out += 1
                next_out += stride
            i_src += 1
    vc.release()

    with open(os.path.join(dst, "fps.txt"), "w") as fp:
        fp.write(f"{out_fps}\n")
    print(f"[{video_rel}] {i_out} frames @ {out_fps:.3f} fps -> {dst}")
    return {"video": name, "num_frames": i_out, "fps": out_fps}


def filter_by_game_list(videos: List[str], game_list: str) -> List[str]:
    """Keep videos whose path (sans extension) starts with a game from the
    split JSON — offline equivalent of getListGames filtering
    (ref: extract_frames_sn.py:224)."""
    import json
    import re

    with open(game_list) as fp:
        metas = json.load(fp)
    games = set()
    for m in metas:
        games.add(m["video"])
        parts = m["video"].split("/")
        # SN metadata names halves ('<game>/half1'); the container files
        # live in the game directory, so match on it too.
        if re.fullmatch(r"(half)?\d+", parts[-1]):
            games.add("/".join(parts[:-1]))
    out = []
    for v in videos:
        stem = os.path.splitext(v)[0]
        parts = stem.split("/")
        prefixes = {"/".join(parts[:i]) for i in range(1, len(parts) + 1)}
        if prefixes & games:
            out.append(v)
    return out


def main(argv=None) -> None:
    args = get_args(argv)
    videos = find_videos(args.video_dir)
    if args.game_list:
        videos = filter_by_game_list(videos, args.game_list)
    if not videos:
        raise SystemExit(f"No videos under {args.video_dir}")
    size = None if args.no_resize else (args.width, args.height)
    tasks = [
        (v, args.video_dir, args.out_dir, args.sample_fps, size,
         args.recalc_fps, args.half_dirs)
        for v in videos
    ]
    workers = max(1, min(args.num_workers or 1, len(tasks)))
    if workers == 1:
        metas = [extract_one(t) for t in tasks]
    else:
        with Pool(workers) as pool:
            metas = pool.map(extract_one, tasks)
    done = [m for m in metas if m]
    print(f"Extracted {len(done)}/{len(videos)} videos")


if __name__ == "__main__":
    main()
