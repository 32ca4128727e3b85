"""The port's load_clip through the native decoder's batch path against the
JAX package's (tdeed_tpu/data/frames.py with its native decoder), bit for
bit (tolerance 0): every clip of make_finediving_fixture's plans, at two
strides, padded and cut, with no frame cache and through one, cold and
warm; a corrupt frame and a mid-clip resolution change raise the same
exception on both sides. Mirrors tests/test_frame_cache.py and
tests/test_data_pipeline.py::test_native_decoder_parity."""

import os
import shutil

import numpy as np
import pytest

from tdeed_tpu.data import frames as jframes
from tdeed_tpu.data.clips import plan_clips
from tdeed_tpu.data.loader import FrameCache as JFrameCache
from tdeed_tpu.data.registry import load_classes
from tdeed_tpu.native import jpeg as jjpeg
from tdeed_tpu_torch.data import frames as pframes
from tdeed_tpu_torch.data.loader import FrameCache as PFrameCache
from tdeed_tpu_torch.native import jpeg as pjpeg
from tests.fixtures import _write_jpeg, make_finediving_fixture

CLIP_LEN = 8


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    root = tmp_path_factory.mktemp("fn")
    fx = make_finediving_fixture(str(root), num_videos=2, num_frames=24)
    classes = load_classes(os.path.join(fx["data_root"], "finediving", "class.txt"))
    split = os.path.join(fx["data_root"], "finediving", "train.json")
    return {stride: plan_clips("finediving", split, fx["frame_dir"], classes, CLIP_LEN,
                               stride=stride, overlap=0.5, radi_displacement=1)
            for stride in (1, 2)}


@pytest.fixture
def batch_calls(monkeypatch):
    """Counts the port's C++ batch decodes."""
    calls = []
    decode_batch = pjpeg.decode_batch

    def counted(paths, *a, **kw):
        calls.append(len(paths))
        return decode_batch(paths, *a, **kw)

    monkeypatch.setattr(pjpeg, "decode_batch", counted)
    return calls


def test_native_is_the_decoder_both_sides_pick():
    assert pframes.get_decoder("native") is pjpeg.decode
    assert pframes.get_decoder("auto") is pjpeg.decode
    assert jframes.get_decoder("auto") is jjpeg.decode


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("pad", [True, False])
def test_load_clip_equals_jax_uncached_cold_and_warm(plans, batch_calls, stride, pad):
    pdec, jdec = pframes.get_decoder("native"), jframes.get_decoder("native")
    pcache, jcache = PFrameCache(64 << 20), JFrameCache(64 << 20)
    padded = 0
    for rec in plans[stride].frame_paths:
        want = jframes.load_clip(rec, stride, jdec, pad=pad)
        padded += rec[2] > 0 or rec[3] > 0
        for got in (pframes.load_clip(rec, stride, pdec, pad=pad),
                    pframes.load_clip(rec, stride, None, pad=pad),  # probes itself
                    pframes.load_clip(rec, stride, pdec, pad=pad, cache=pcache),  # cold
                    pframes.load_clip(rec, stride, pdec, pad=pad, cache=pcache)):  # warm
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
        for _ in ("cold", "warm"):
            np.testing.assert_array_equal(
                jframes.load_clip(rec, stride, jdec, pad=pad, cache=jcache), want)
    assert padded > 0  # the plans pad clips at the videos' ends
    # every uncached read and every cold cached one with a miss went through C++
    assert len(batch_calls) >= 2 * len(plans[stride].frame_paths)
    assert (pcache.hits, pcache.misses) == (jcache.hits, jcache.misses) and pcache.hits > 0


def test_other_decoders_never_take_the_batch_path(plans, batch_calls):
    """cfg.decoder 'pil' is honoured: frame by frame, the same pixels."""
    rec = plans[1].frame_paths[0]
    got = pframes.load_clip(rec, 1, pframes.get_decoder("pil"))
    assert not batch_calls
    np.testing.assert_array_equal(got, jframes.load_clip(rec, 1, jframes.get_decoder("pil")))


def _clip_copy(tmp_path, rec):
    """A copy of the clip's frame directory and the record pointing at it."""
    src = rec[0]
    dst = str(tmp_path / "frames")
    shutil.copytree(src, dst)
    return [dst] + list(rec[1:]), pframes._clip_frame_paths([dst] + list(rec[1:]), 1, True)


@pytest.mark.parametrize("cached", [False, True])
def test_a_corrupt_frame_mid_clip_raises_like_jax(plans, tmp_path, cached):
    rec = next(r for r in plans[1].frame_paths if r[2] == 0 and r[3] == 0)
    rec, slots = _clip_copy(tmp_path, rec)
    victim = slots[CLIP_LEN // 2]
    with open(victim, "rb") as fp:
        data = fp.read()
    with open(victim, "wb") as fp:
        fp.write(data[:200])  # cut inside the header: libjpeg errors out
    errors = []
    for frames, cache, dec in ((pframes, PFrameCache(64 << 20) if cached else None,
                                pframes.get_decoder("native")),
                               (jframes, JFrameCache(64 << 20) if cached else None,
                                jframes.get_decoder("native"))):
        with pytest.raises(Exception) as e:
            frames.load_clip(rec, 1, dec, cache=cache)
        errors.append(e.type)
    assert errors[0] is errors[1] and issubclass(errors[0], OSError)


@pytest.mark.parametrize("cached", [False, True])
def test_a_mid_clip_resolution_change_raises_like_jax(plans, tmp_path, cached):
    rec = next(r for r in plans[1].frame_paths if r[2] == 0 and r[3] == 0)
    rec, slots = _clip_copy(tmp_path, rec)
    _write_jpeg(slots[CLIP_LEN - 1], np.full((32, 24, 3), 128, np.uint8))
    errors = []
    for frames, cache, dec in ((pframes, PFrameCache(64 << 20) if cached else None,
                                pframes.get_decoder("native")),
                               (jframes, JFrameCache(64 << 20) if cached else None,
                                jframes.get_decoder("native"))):
        with pytest.raises(ValueError) as e:
            frames.load_clip(rec, 1, dec, cache=cache)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
