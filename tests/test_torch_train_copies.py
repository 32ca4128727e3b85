"""The port's copies of the JAX package's training-side host modules
against their originals, on tests.fixtures.make_finediving_fixture:
data/clips.py, data/frames.py (load_clip), data/loader.py (ClipSampler,
BatchLoader) and utils/logging.py (MetricsLogger). Every comparison is
exact; the store pickles are compared byte for byte. Also the port's own
``device_prefetch`` on the CPU, and the loader's failure path."""

import filecmp
import json
import os
import threading

import numpy as np
import pytest
import torch

import tdeed_tpu.data.clips as jclips
import tdeed_tpu.data.frames as jframes
import tdeed_tpu.data.loader as jloader
import tdeed_tpu.utils.logging as jlogging
import tdeed_tpu_torch.data.clips as pclips
import tdeed_tpu_torch.data.frames as pframes
import tdeed_tpu_torch.data.loader as ploader
import tdeed_tpu_torch.utils.logging as plogging
from tests.fixtures import make_finediving_fixture

CLASSES = {f"class{i}": i for i in range(1, 5)}
SIDES = ((jclips, jframes, jloader), (pclips, pframes, ploader))


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return make_finediving_fixture(str(tmp_path_factory.mktemp("train_copies")),
                                   num_videos=2, num_frames=24, size=16)


def _plan(clips, fx, split, clip_len, radi, overlap=0.9):
    return clips.plan_clips(
        "finediving", os.path.join(fx["data_root"], "finediving", f"{split}.json"),
        fx["frame_dir"], CLASSES, clip_len, 1, overlap, radi,
    )


@pytest.mark.parametrize("split,clip_len,radi,overlap", [
    ("train", 8, 2, 0.9), ("train", 16, 0, 0.5), ("val", 8, 1, 1.0), ("test", 30, 3, 0.9),
])
def test_plan_and_store_match(fx, tmp_path, split, clip_len, radi, overlap):
    """Equal plans, and byte-equal pickles in the reference's layout."""
    want = _plan(jclips, fx, split, clip_len, radi, overlap)
    got = _plan(pclips, fx, split, clip_len, radi, overlap)
    assert len(got) == len(want) > 0
    assert (got.frame_paths, got.labels, got.labels_d) == \
        (want.frame_paths, want.labels, want.labels_d)
    dirs = [clips.store_plan(plan, str(tmp_path / side), clip_len, radi, split)
            for side, clips, plan in (("jax", jclips, want), ("port", pclips, got))]
    names = sorted(os.listdir(dirs[0]))
    assert names == sorted(os.listdir(dirs[1]))
    assert names == ["frame_paths.pkl", "labels.pkl"] + (["labelsD.pkl"] if radi else [])
    for name in names:
        assert filecmp.cmp(os.path.join(dirs[0], name), os.path.join(dirs[1], name),
                           shallow=False), name


def test_load_plan_reads_either_store(fx, tmp_path):
    plan = _plan(jclips, fx, "train", 8, 2)
    for writer in (jclips, pclips):
        store = str(tmp_path / writer.__name__)
        writer.store_plan(plan, store, 8, 2, "train")
        for reader in (jclips, pclips):
            got = reader.load_plan(store, 8, 2, "train")
            assert (got.frame_paths, got.labels, got.labels_d) == \
                (plan.frame_paths, plan.labels, plan.labels_d)


def test_rasterize_labels_matches(fx):
    plan = _plan(jclips, fx, "train", 8, 2)
    for labels, labels_d in zip(plan.labels, plan.labels_d):
        for d in (labels_d, None):
            want = jclips.rasterize_labels(labels, d, 8)
            got = pclips.rasterize_labels(labels, d, 8)
            np.testing.assert_array_equal(got[0], want[0])
            assert (got[1] is None) == (want[1] is None)
            if d is not None:
                np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("pad,cached", [(True, False), (False, False), (True, True)],
                         ids=["pad", "no-pad", "cache"])
def test_load_clip_matches(fx, pad, cached):
    """Every clip of a plan that pads at both ends, with and without the
    frame cache (cold, then warm)."""
    plan = _plan(jclips, fx, "train", 8, 2)
    outs = []
    for _, frames, loader in SIDES:
        cache = loader.FrameCache(1 << 20) if cached else None
        dec = frames.get_decoder("pil")
        outs.append(([frames.load_clip(p, 1, dec, pad=pad, cache=cache)
                      for _ in range(2 if cached else 1) for p in plan.frame_paths],
                     cache.stats() if cached else None))
    (want, jstats), (got, pstats) = outs
    assert pstats == jstats
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def _epochs(side, fx, mixup, epoch, start_batch, cached):
    clips, frames, loader = side
    plan = _plan(clips, fx, "train", 8, 2)
    cache = loader.FrameCache(1 << 20) if cached else None
    sampler = loader.ClipSampler(plan, 8, 1, 2, mixup, decoder=frames.get_decoder("pil"),
                                 cache=cache)
    bl = loader.BatchLoader(sampler, 3, 20, num_workers=3, prefetch=2, seed=5)
    return list(bl.epoch(epoch, start_batch=start_batch))


@pytest.mark.parametrize("mixup,epoch,start_batch,cached", [
    (True, 0, 0, False), (True, 3, 4, True), (False, 1, 2, False),
])
def test_batch_loader_epochs_match(fx, mixup, epoch, start_batch, cached):
    want = _epochs(SIDES[0], fx, mixup, epoch, start_batch, cached)
    got = _epochs(SIDES[1], fx, mixup, epoch, start_batch, cached)
    assert len(got) == len(want) == 20 // 3 - start_batch
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_batch_loader_start_batch_resumes_the_epoch(fx):
    """Batch b of epoch e is a pure function of (seed, e, b)."""
    full = _epochs(SIDES[1], fx, True, 2, 0, False)
    tail = _epochs(SIDES[1], fx, True, 2, 4, False)
    for g, w in zip(tail, full[4:]):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_batch_loader_failure_path(fx):
    """A decode error in a worker thread reaches the consumer; abandoning
    the epoch stops the producer thread."""
    plan = _plan(pclips, fx, "train", 8, 2)

    def broken(path):
        raise OSError(f"cannot decode {path}")

    bad = ploader.BatchLoader(ploader.ClipSampler(plan, 8, 1, 2, False, decoder=broken), 2, 8)
    with pytest.raises(OSError, match="cannot decode"):
        list(bad.epoch(0))

    before = set(threading.enumerate())
    good = ploader.BatchLoader(
        ploader.ClipSampler(plan, 8, 1, 2, True, decoder=pframes.get_decoder("pil")),
        2, 200, num_workers=2, prefetch=1,
    )
    it = good.epoch(0)
    next(it)
    it.close()  # the consumer walks away with the queue full
    started = set(threading.enumerate()) - before
    for t in started:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in started)


def test_device_prefetch_on_the_cpu():
    """Batches come out in order as tensors; tensors already on the
    device pass through as the same objects."""
    rng = np.random.default_rng(0)
    batches = [{"frame": rng.integers(0, 256, (2, 4, 8, 8, 3), dtype=np.uint8),
                "label": torch.arange(8).view(2, 4) + i} for i in range(5)]
    out = list(ploader.device_prefetch(iter(batches), "cpu", depth=2))
    assert len(out) == 5
    for got, want in zip(out, batches):
        assert isinstance(got["frame"], torch.Tensor)
        np.testing.assert_array_equal(got["frame"].numpy(), want["frame"])
        assert got["label"] is want["label"]


def test_metrics_logger_writes_the_same_json(tmp_path):
    maps, tols = [0.125, 0.5, 0.3333], [1, 2, 4]
    for side, mod in (("jax", jlogging), ("port", plogging)):
        logger = mod.MetricsLogger(str(tmp_path / side), cfg=None, enable_wandb=False)
        logger.log_epoch({"epoch": 0, "train": 1.0, "val": 2.0})
        logger.log_test("test", maps, tols)
        logger.finish()
    a, b = (tmp_path / s / "results_test.json" for s in ("jax", "port"))
    assert filecmp.cmp(a, b, shallow=False)
    assert json.loads(b.read_text()) == {
        "test_mAP@1": 0.125, "test_mAP@2": 0.5, "test_mAP@4": 0.3333,
        "test_avg_mAP": float(np.mean(maps)),
    }
