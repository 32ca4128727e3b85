"""The port's copy of the frame extractor (tdeed_tpu_torch/cli/extract_frames.py)
against the JAX module's: the cv2-free functions on the same inputs give the
same results, and extract_one's stride and effective-fps arithmetic, run
against a stand-in cv2 module put into sys.modules for both, writes the same
source frames under the same names with the same fps sidecar and metadata.
Where cv2 is installed, both extract the same real video to the same frames."""

import json
import os
import sys
import types

import numpy as np
import pytest

from tdeed_tpu.cli import extract_frames as jx
from tdeed_tpu_torch.cli import extract_frames as px


def test_constants_and_arguments_match():
    for name in ("TARGET_HEIGHT", "TARGET_WIDTH", "VIDEO_EXTS", "FRAME_RETRY_THRESHOLD"):
        assert getattr(px, name) == getattr(jx, name)
    argv = ["--video_dir", "v", "--out_dir", "o", "--sample_fps", "12.5", "--recalc_fps",
            "--half_dirs", "--game_list", "g.json", "--num_workers", "3", "--no_resize"]
    assert vars(px.get_args(argv)) == vars(jx.get_args(argv))


def test_find_videos_and_output_names_match(tmp_path):
    for rel in ("b/2_720p.mkv", "b/1_720p.mkv", "a/clip.MP4", "a/notes.txt", "c/d/x.avi",
                "c/d/1.mov", "top.mkv", "e/half.mp4"):
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"")
    videos = px.find_videos(str(tmp_path))
    assert videos == jx.find_videos(str(tmp_path)) and len(videos) == 7
    for v in videos + ["2_720p.mkv", "g/10.mkv", "g/3_720p_extra.mkv"]:
        for half_dirs in (False, True):
            assert px.output_name(v, half_dirs) == jx.output_name(v, half_dirs)
    assert px.output_name("b/2_720p.mkv", True) == "b/half2"


def test_filter_by_game_list_matches(tmp_path):
    videos = [
        "england_efl/2019-2020/2019-10-01 - Leeds United - West Bromwich/video.mp4",
        "england_efl/2019-2020/other game/video.mp4",
        "cup/2021/final/1_720p.mkv",
        "cup/2021/final/2_720p.mkv",
        "cup/2021/semi/1_720p.mkv",
        "league/g7.mp4",
    ]
    split = tmp_path / "train.json"
    split.write_text(json.dumps([
        {"video": "england_efl/2019-2020/2019-10-01 - Leeds United - West Bromwich"},
        {"video": "cup/2021/final/half1"},
        {"video": "league/g7"},
    ]))
    got = px.filter_by_game_list(videos, str(split))
    assert got == jx.filter_by_game_list(videos, str(split))
    assert got == [videos[0], videos[2], videos[3], videos[5]]


class _Capture:
    """A video of ``decoded`` (2, 2, 3) frames whose pixels encode their
    source index, with the container's header fps and count."""

    def __init__(self, spec):
        self.spec, self.pos = spec, 0

    def get(self, prop):
        return {_FakeCV2.CAP_PROP_FPS: self.spec["fps"],
                _FakeCV2.CAP_PROP_FRAME_COUNT: self.spec["header_count"],
                _FakeCV2.CAP_PROP_POS_MSEC: self.spec["msec"] if self.pos else 0.0}[prop]

    def grab(self):
        if self.pos >= self.spec["decoded"]:
            return False
        self.pos += 1
        return True

    def read(self):
        if not self.grab():
            return False, None
        i = self.pos - 1
        return True, np.full((2, 2, 3), [i % 256, i // 256, 0], np.uint8)

    def release(self):
        pass


class _FakeCV2(types.ModuleType):
    CAP_PROP_FPS, CAP_PROP_FRAME_COUNT, CAP_PROP_POS_MSEC = 5, 7, 0
    INTER_AREA, IMWRITE_JPEG_QUALITY = 3, 1

    def __init__(self, specs):
        super().__init__("cv2")
        self.specs, self.writes = specs, []

    def VideoCapture(self, path):
        return _Capture(self.specs[os.path.basename(path)])

    def resize(self, frame, size, interpolation):
        assert interpolation == self.INTER_AREA
        self.writes.append(("resize", tuple(size)))
        return frame

    def imwrite(self, path, frame, params):
        assert params == [self.IMWRITE_JPEG_QUALITY, 95]
        self.writes.append((os.path.basename(path), int(frame[0, 0, 0]) + 256 * int(frame[0, 0, 1])))
        return True


# (fps, header count, decoded count, ms at the end, sample fps, recalc):
# plain stride 2, a fractional stride, no down-sampling, the effective-fps
# repair (header 400 frames beyond the decoded), a measured fps that
# disagrees with the header, and an unreadable fps
CASES = {
    "stride2.mp4": (dict(fps=10.0, header_count=30, decoded=30, msec=3000.0), 5.0, False),
    "stride2.5.mp4": (dict(fps=25.0, header_count=101, decoded=101, msec=4040.0), 10.0, False),
    "upsample.mp4": (dict(fps=5.0, header_count=20, decoded=20, msec=4000.0), 25.0, False),
    "repair.mkv": (dict(fps=25.0, header_count=700, decoded=300, msec=12000.0), 12.5, True),
    "measured.mkv": (dict(fps=30.0, header_count=90, decoded=90, msec=3600.0), 12.5, True),
    "nofps.mp4": (dict(fps=0.0, header_count=0, decoded=5, msec=0.0), 5.0, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_extract_one_arithmetic_matches_through_a_stand_in_cv2(monkeypatch, tmp_path, capsys,
                                                                name):
    spec, sample_fps, recalc = CASES[name]
    results = []
    for mod in (jx, px):
        fake = _FakeCV2({name: spec})
        monkeypatch.setitem(sys.modules, "cv2", fake)
        out_dir = tmp_path / mod.__name__.split(".")[0]
        meta = mod.extract_one((name, str(tmp_path), str(out_dir), sample_fps, (8, 6), recalc,
                                False))
        sidecar = out_dir / os.path.splitext(name)[0] / "fps.txt"
        results.append((meta, fake.writes, sidecar.read_text() if sidecar.exists() else None,
                        capsys.readouterr().out.replace(str(out_dir), "OUT")))
    assert results[1] == results[0]
    meta, writes = results[0][:2]
    if spec["fps"] <= 0:
        assert meta is None and not writes
    else:
        assert meta["num_frames"] == sum(1 for w in writes if w[0] != "resize") > 0


def test_real_video_extracts_to_the_same_frames(tmp_path):
    """Both modules' main() over one real video: the same frame files,
    decoded to the same pixels, and the same sidecar."""
    cv2 = pytest.importorskip("cv2")
    vid_dir = tmp_path / "videos"
    (vid_dir / "league").mkdir(parents=True)
    vw = cv2.VideoWriter(str(vid_dir / "league" / "g1.mp4"), cv2.VideoWriter_fourcc(*"mp4v"),
                         10.0, (64, 48))
    rng = np.random.default_rng(0)
    for _ in range(20):
        vw.write(rng.integers(0, 256, (48, 64, 3), np.uint8))
    vw.release()
    outs = []
    for mod in (jx, px):
        out = tmp_path / mod.__name__.split(".")[0]
        mod.main(["--video_dir", str(vid_dir), "--out_dir", str(out), "--sample_fps", "5",
                  "--width", "32", "--height", "24", "--num_workers", "1"])
        outs.append(out / "league" / "g1")
    names = sorted(os.listdir(outs[0]))
    assert names == sorted(os.listdir(outs[1])) and len(names) == 11  # 10 frames + fps.txt
    for n in names:
        a, b = (str(o / n) for o in outs)
        if n.endswith(".jpg"):
            np.testing.assert_array_equal(cv2.imread(a), cv2.imread(b))
        else:
            assert open(a).read() == open(b).read()
