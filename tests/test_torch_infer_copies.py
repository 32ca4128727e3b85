"""The port's copies of the JAX package's JAX-free host modules against
their originals, on the same inputs made from a numpy seed:
data/registry.py, utils/io.py, data/frames.py (get_decoder, load_window),
data/loader.py (FrameCache), infer/nms.py, metrics/map.py,
infer/windows.py and infer/evaluate.py (with an oracle numpy predict_fn).
Every comparison is exact."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

import tdeed_tpu.data.frames as jframes
import tdeed_tpu.data.loader as jloader
import tdeed_tpu.data.registry as jreg
import tdeed_tpu.infer.evaluate as jeval
import tdeed_tpu.infer.nms as jnms
import tdeed_tpu.infer.windows as jwin
import tdeed_tpu.metrics.map as jmap
import tdeed_tpu.utils.io as jio
import tdeed_tpu_torch.data.frames as pframes
import tdeed_tpu_torch.data.loader as ploader
import tdeed_tpu_torch.data.registry as preg
import tdeed_tpu_torch.infer.evaluate as peval
import tdeed_tpu_torch.infer.nms as pnms
import tdeed_tpu_torch.infer.windows as pwin
import tdeed_tpu_torch.metrics.map as pmap
import tdeed_tpu_torch.utils.io as pio
from tests.fixtures import make_finediving_fixture

DATASETS = sorted(jreg.DATASETS)
CLASSES = [f"class{i}" for i in range(1, 5)]


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return make_finediving_fixture(str(tmp_path_factory.mktemp("copies")), num_videos=2,
                                   num_frames=24, size=16)


# -- data/registry.py --------------------------------------------------------

def _resolve_args(name, root):
    os.makedirs(os.path.join(root, "01", "02"), exist_ok=True)
    open(os.path.join(root, "01", "02", "0003.jpg"), "w").close()
    return {
        "finediving": ("01__02", None),
        "tennis": ("base_name_10_20", None),
        "finegym": ("vid_E_000", {"start_frame": 30, "pad": [5, 5]}),
    }.get(name, ("league/game/1", None))


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_spec_matches(name, tmp_path):
    j, p = jreg.get_spec(name), preg.get_spec(name)
    fields = [f.name for f in dataclasses.fields(j)]
    assert fields == [f.name for f in dataclasses.fields(p)]
    for f in fields:
        if f != "scheme":
            assert getattr(p, f) == getattr(j, f), f
    video, info = _resolve_args(name, str(tmp_path))
    assert p.scheme.resolve(str(tmp_path), video, info) == \
        j.scheme.resolve(str(tmp_path), video, info)
    for clip_len in (8, 50, 100):
        assert p.eval_overlap_len(clip_len) == j.eval_overlap_len(clip_len)


def test_registry_constants_match():
    assert sorted(preg.DATASETS) == DATASETS
    assert (preg.FPS_SN, preg.DEFAULT_PAD_LEN) == (jreg.FPS_SN, jreg.DEFAULT_PAD_LEN)
    for n in range(0, 40):
        for stride in (1, 2, 12):
            assert preg.strided_video_len(n, stride) == jreg.strided_video_len(n, stride)
    with pytest.raises(KeyError):
        preg.get_spec("nope")


def test_load_classes_matches(tmp_path):
    path = tmp_path / "class.txt"
    path.write_text("a\n\n  b  \nc\n\n")
    assert preg.load_classes(str(path)) == jreg.load_classes(str(path)) == {"a": 1, "b": 2, "c": 3}


@pytest.mark.parametrize("name", DATASETS)
def test_event_frame_matches(name):
    rng = np.random.default_rng(1)
    for _ in range(20):
        e = {"frame": int(rng.integers(0, 5000)), "position": str(int(rng.integers(0, 3e6))),
             "gameTime": f"{int(rng.integers(1, 3))} - 12:34"}
        assert preg.event_frame(e, name) == jreg.event_frame(e, name)


# -- utils/io.py -------------------------------------------------------------

def _random_pred(rng, videos, n_events=12, labels=CLASSES):
    return [
        {"video": v, "fps": 25.0, "events": [
            {"label": labels[int(rng.integers(0, len(labels)))],
             "frame": int(rng.integers(0, 400)),
             "score": float(np.round(rng.random(), 2))}
            for _ in range(n_events)]}
        for v in videos
    ]


@pytest.mark.parametrize("writer", ["store_json_sn", "store_json_snb", "store_json"])
def test_writers_give_byte_equal_files(writer, tmp_path):
    rng = np.random.default_rng(2)
    videos = ["league/2020/game1/1", "league/2020/game1/2", "league/2021/game2/1",
              "league/2021/game2/2"]
    pred = _random_pred(rng, videos)
    for side, io in (("jax", jio), ("port", pio)):
        os.makedirs(tmp_path / side / "run")
        path = str(tmp_path / side / "run" / "pred-test")
        if writer == "store_json":
            io.store_json(path + ".json", pred, pretty=True)
        else:
            getattr(io, writer)(path, pred, stride=12)
    cmp = filecmp.dircmp(tmp_path / "jax", tmp_path / "port")
    files = []
    for root, _, names in os.walk(tmp_path / "jax"):
        files += [os.path.relpath(os.path.join(root, n), tmp_path / "jax") for n in names]
    assert files and not cmp.left_only and not cmp.right_only
    for f in files:
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "port" / f, shallow=False), f
    assert pio.load_json(str(tmp_path / "port" / files[0])) == \
        jio.load_json(str(tmp_path / "jax" / files[0]))


# -- infer/nms.py ------------------------------------------------------------

@pytest.mark.parametrize("kind", ["nms", "snms"])
@pytest.mark.parametrize("name", DATASETS)
def test_nms_matches(name, kind):
    """Seeded event lists with tied scores (two decimals), at the
    dataset's windows, one window per class, and several thresholds."""
    rng = np.random.default_rng(3)
    spec = jreg.get_spec(name)
    window = spec.windows[0] if kind == "nms" else spec.windows[1]
    fn = "non_maximum_suppression" if kind == "nms" else "soft_non_maximum_suppression"
    for threshold in (0.0, 0.01, 0.3):
        for w in (window, [window, window + 1, 2, 1]):
            pred = _random_pred(rng, ["v1", "v2"], n_events=60)
            want = getattr(jnms, fn)(pred, w, threshold)
            assert getattr(pnms, fn)(pred, w, threshold) == want


# -- metrics/map.py ----------------------------------------------------------

@pytest.mark.parametrize("name", ["finediving", "soccernetball"])
def test_compute_maps_matches(name, tmp_path, capsys):
    rng = np.random.default_rng(4)
    tolerances = jreg.get_spec(name).tolerances
    videos = ["v1", "v2", "v3"]
    truth = [{"video": v, "events": [
        {"label": CLASSES[int(rng.integers(0, 4))], "frame": int(rng.integers(0, 400))}
        for _ in range(15)]} for v in videos]
    pred = _random_pred(rng, videos, n_events=80)
    want = jmap.compute_maps(truth, pred, tolerances, printed=True)
    printed = capsys.readouterr().out
    got = pmap.compute_maps(truth, pred, tolerances, printed=True)
    assert got == want and 0 < np.mean(want[0]) <= 1
    assert capsys.readouterr().out == printed
    for tol in tolerances:
        for label in CLASSES:
            flat = pmap.get_predictions(pred, label=label)
            assert flat == jmap.get_predictions(pred, label=label)
            gt = pmap.parse_ground_truth(truth)[label]
            assert pmap.compute_average_precision(flat, gt, tol) == \
                jmap.compute_average_precision(flat, gt, tol)


# -- data/frames.py and data/loader.py ----------------------------------------

@pytest.mark.parametrize("kind", ["pil", "cv2", "auto"])
def test_decoders_match(fx, kind):
    path = os.path.join(fx["frame_dir"], "01", "01", "0001.jpg")
    # both packages' 'auto' picks their C++ decoder where it is built
    want = jframes.get_decoder(kind)(path)
    got = pframes.get_decoder(kind)(path)
    assert got.dtype == np.uint8 and got.shape == (16, 16, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start,end,stride,pad,cached", [
    (-3, 5, 1, True, False),  # start pad
    (20, 28, 1, True, False),  # end pad
    (20, 28, 1, False, False),  # end cut
    (-4, 12, 2, True, False),  # strided
    (2, 10, 1, True, True),  # through the frame cache, cold then warm
    (-3, 29, 2, True, True),
], ids=["start-pad", "end-pad", "end-cut", "strided", "cache", "cache-padded"])
def test_load_window_matches(fx, start, end, stride, pad, cached):
    outs = []
    for frames, loader in ((jframes, jloader), (pframes, ploader)):
        spec = (jreg if frames is jframes else preg).get_spec("finediving")
        cache = loader.FrameCache(1 << 20) if cached else None
        calls = [frames.load_window(spec, fx["frame_dir"], "01__01", start, end, stride,
                                    frames.get_decoder("pil"), pad=pad, cache=cache)
                 for _ in range(2 if cached else 1)]
        outs.append((calls, cache.stats() if cached else None))
    (jcalls, jstats), (pcalls, pstats) = outs
    assert pstats == jstats
    for got, want in zip(pcalls, jcalls):
        np.testing.assert_array_equal(got, want)


def test_frame_cache_matches():
    """Hits, misses, eviction order and byte accounting under a small
    capacity, for the same sequence of puts and gets."""
    rng = np.random.default_rng(5)
    seq = [(str(int(rng.integers(0, 12))), bool(rng.random() < 0.5)) for _ in range(200)]
    caches = [jloader.FrameCache(5 * 768), ploader.FrameCache(5 * 768)]
    for key, put in seq:
        arr = np.full((16, 16, 3), int(key), np.uint8)
        got = []
        for c in caches:
            if put:
                c.put(key, arr)
            hit = c.get(key)
            got.append(None if hit is None else hit.tolist())
        assert got[0] == got[1]
    assert caches[0].stats() == caches[1].stats()
    assert list(caches[0]._data) == list(caches[1]._data)


# -- infer/windows.py --------------------------------------------------------

WINDOW_CASES = [(8, 6, 1), (8, 0, 2), (16, 12, 1)]


def _windows(mod, frames, fx, split, clip_len, overlap, stride):
    return mod.VideoWindows(
        "finediving", os.path.join(fx["data_root"], "finediving", f"{split}.json"),
        fx["frame_dir"], clip_len, overlap_len=overlap, stride=stride,
        decoder=frames.get_decoder("pil"),
    )


@pytest.mark.parametrize("clip_len,overlap,stride", WINDOW_CASES)
def test_video_windows_match(fx, clip_len, overlap, stride):
    j = _windows(jwin, jframes, fx, "train", clip_len, overlap, stride)
    p = _windows(pwin, pframes, fx, "train", clip_len, overlap, stride)
    assert p.clips == j.clips and len(p) == len(j)
    assert p.videos == j.videos
    assert p.labels == j.labels
    classes = {c: i + 1 for i, c in enumerate(CLASSES)}
    for video, _, _ in j.videos:
        np.testing.assert_array_equal(p.get_labels(video, classes), j.get_labels(video, classes))
    jb, pb = list(j.batches(3, num_workers=2)), list(p.batches(3, num_workers=2))
    assert len(pb) == len(jb)
    for pbatch, jbatch in zip(pb, jb):
        assert [(c["video"], c["start"]) for c in pbatch] == \
            [(c["video"], c["start"]) for c in jbatch]
        for pc, jc in zip(pbatch, jbatch):
            np.testing.assert_array_equal(pc["frame"], jc["frame"])


# -- infer/evaluate.py -------------------------------------------------------

def _oracle_predict_fn(hflip_shift=0.3):
    """Scores from each frame's left-half colour means (so the flip
    matters), float64, with rows whose red mean is low zeroed (so support
    counting sees empty rows)."""
    w = np.random.default_rng(6).normal(size=(3, len(CLASSES) + 1))

    def predict(frames, hflip):
        x = frames[:, :, :, ::-1] if hflip else frames
        feat = x[:, :, :, : x.shape[3] // 2].mean(axis=(2, 3)) / 255.0  # (B, T, 3)
        logits = feat @ w + (hflip_shift if hflip else 0.0)
        p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        p[feat[..., 0] < 0.45] = 0.0
        return p

    return predict


@pytest.mark.parametrize("augment", [False, True], ids=["plain", "tta"])
@pytest.mark.parametrize("clip_len,overlap,stride", WINDOW_CASES)
def test_run_inference_and_frame_predictions_match(fx, clip_len, overlap, stride, augment):
    classes = {c: i + 1 for i, c in enumerate(CLASSES)}
    outs = []
    for frames, win, ev in ((jframes, jwin, jeval), (pframes, pwin, peval)):
        data = _windows(win, frames, fx, "train", clip_len, overlap, stride)
        pred_dict = ev.run_inference(_oracle_predict_fn(), data, classes, augment,
                                     batch_size=1 if augment else 3)
        err, f1, events, events_hr, scores = ev.process_frame_predictions(
            data, classes, pred_dict, with_scores=True)
        f1s = {k: (f1.get(k), f1.tp_fp_fn(k)) for k in [None, *classes.values()]}
        outs.append((pred_dict, err.get(), f1s, events, events_hr, scores))
    (jpd, *jrest), (ppd, *prest) = outs
    assert sorted(ppd) == sorted(jpd)
    for video in jpd:
        for got, want in zip(ppd[video], jpd[video]):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    if not augment:  # some rows were empty in every window: support 0 there
        assert any((support == 0).any() for _, support in jpd.values())
    assert prest == jrest


def test_accumulate_scores_matches():
    rng = np.random.default_rng(7)
    dicts = [{"v": (np.zeros((30, 5), np.float32), np.zeros(30, np.int32))} for _ in range(2)]
    for _ in range(40):
        start = int(rng.integers(-10, 30))
        scores = rng.random((8, 5)).astype(np.float32)
        rows = None if rng.random() < 0.5 else rng.integers(0, 2, 8).astype(np.int32)
        jeval.accumulate_scores(dicts[0], "v", start, scores, rows)
        peval.accumulate_scores(dicts[1], "v", start, scores, rows)
    for got, want in zip(dicts[1]["v"], dicts[0]["v"]):
        np.testing.assert_array_equal(got, want)
