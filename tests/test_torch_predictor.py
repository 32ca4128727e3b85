"""The port's inference and serving layer against the JAX package's, same
weights: ``SpottingPredictor.spot()`` (TTA off and on, NMS none / nms /
snms), the port's two aggregation paths against each other, and
``evaluate()`` in val and test mode.

Fixture: ``tests.fixtures.make_finediving_fixture`` with one 24-frame
video per split at 16x16; ``write_tiny_config`` (clip 8, crop 16, PIL
decoder, fp32) loaded by each package's own ``load_config``; one JAX
``model.init`` from PRNGKey(0), carried to the port by
``SpottingPredictor.from_jax_params``. Eval-mode BN reads running
statistics, so the scores agree to rtol 1e-4 / atol 1e-6 (the train-mode
floor of the step tests does not apply).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tdeed_tpu import config as jax_config
from tdeed_tpu.data.frames import get_decoder as jax_get_decoder
from tdeed_tpu.infer import evaluate as jax_eval
from tdeed_tpu.infer.predictor import SpottingPredictor as JaxPredictor
from tdeed_tpu.infer.windows import VideoWindows as JaxWindows
from tdeed_tpu.models.tdeed import build_model as jax_build_model
from tdeed_tpu_torch import config as port_config
from tdeed_tpu_torch.data.frames import get_decoder
from tdeed_tpu_torch.data.registry import get_spec, load_classes
from tdeed_tpu_torch.infer import evaluate as port_eval
from tdeed_tpu_torch.infer.predictor import SpottingPredictor
from tdeed_tpu_torch.infer.windows import VideoWindows
from tests import torch_port_util  # noqa: F401  (one torch thread per worker)
from tests.fixtures import make_finediving_fixture, write_tiny_config

RTOL, ATOL = 1e-4, 1e-6
CLIP = 8


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_predictor"))
    fx = make_finediving_fixture(root, num_videos=1, num_frames=24, size=16)
    cfg_root = write_tiny_config(root, fx, clip_len=CLIP, crop_dim=16,
                                 decoder="pil", dtype="float32")
    jcfg = jax_config.load_config("FineDiving_tiny", cfg_root)
    pcfg = port_config.load_config("FineDiving_tiny", cfg_root)
    v = jax.jit(jax_build_model(jcfg).init, static_argnums=(2,))(
        jax.random.PRNGKey(0), jnp.zeros((1, CLIP, 16, 16, 3), jnp.float32), False
    )
    classes = load_classes(os.path.join(fx["data_root"], "finediving", "class.txt"))
    jpred = JaxPredictor(jcfg, v["params"], v["batch_stats"], classes)
    ppred = SpottingPredictor.from_jax_params(
        pcfg, v["params"], v["batch_stats"], classes, device="cpu"
    )
    with open(os.path.join(fx["data_root"], "finediving", "train.json")) as fp:
        meta = json.load(fp)[0]
    return fx, jpred, ppred, meta, classes


def _spot(pred, fx, meta, **kw):
    return pred.spot(fx["frame_dir"], meta["video"], meta["num_frames"], **kw)


def _assert_same_events(got, want):
    assert [(e["label"], e["frame"]) for e in got] == [(e["label"], e["frame"]) for e in want]
    np.testing.assert_allclose([e["score"] for e in got], [e["score"] for e in want],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("nms", ["none", "nms", "snms"])
@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_spot_matches_jax(setup, tta, nms):
    fx, jpred, ppred, meta, _ = setup
    want = _spot(jpred, fx, meta, hflip_tta=tta, nms=nms)
    got = _spot(ppred, fx, meta, hflip_tta=tta, nms=nms)
    assert want, "the fixture must spot some events"
    _assert_same_events(got, want)


def test_spot_many_matches_jax(setup):
    fx, jpred, ppred, _, _ = setup
    with open(os.path.join(fx["data_root"], "finediving", "test.json")) as fp:
        metas = json.load(fp)
    want = jpred.spot_many(fx["frame_dir"], metas, hflip_tta=False)
    got = ppred.spot_many(fx["frame_dir"], metas, hflip_tta=False)
    assert list(got) == list(want) == [m["video"] for m in metas]
    for video in want:
        _assert_same_events(got[video], want[video])


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_device_and_host_aggregation_give_equal_bits(setup, tta):
    """Every (frame, class) score (threshold 0, no NMS) of the two paths,
    compared exactly. Batches of 5 over the video's 12 windows leave a
    ragged last batch of 2 (TTA runs batches of 1)."""
    fx, _, ppred, meta, _ = setup
    ppred.batch_size = 5
    try:
        assert len(ppred._windows(meta["num_frames"])) % 5 != 0
        kw = dict(hflip_tta=tta, nms="none", threshold=0.0)
        dev = _spot(ppred, fx, meta, device_aggregate=True, **kw)
        host = _spot(ppred, fx, meta, device_aggregate=False, **kw)
    finally:
        ppred.batch_size = 4
    assert len(dev) == meta["num_frames"] * len(ppred.classes)
    assert dev == host


def _windows(cls, decoder, fx, split):
    return cls(
        "finediving", os.path.join(fx["data_root"], "finediving", f"{split}.json"),
        fx["frame_dir"], CLIP, overlap_len=get_spec("finediving").eval_overlap_len(CLIP),
        stride=1, decoder=decoder,
    )


def _jax_predict_fn(jpred):
    return lambda frames, hflip: jpred._predict(
        jpred._params, jpred._batch_stats, frames, hflip)[1]


def test_evaluate_val_map_matches_jax(setup):
    fx, jpred, ppred, _, classes = setup
    want = jax_eval.evaluate(_jax_predict_fn(jpred), _windows(JaxWindows, jax_get_decoder("pil"), fx, "val"),
                             "val", classes, printed=False)
    got = port_eval.evaluate(ppred.predict_fn, _windows(VideoWindows, get_decoder("pil"), fx, "val"),
                             "val", classes, printed=False)
    assert want > 0, "the fixture must score some events"
    assert abs(got - want) <= 1e-6


def test_evaluate_test_mode_stores_the_same_predictions(setup, tmp_path):
    fx, jpred, ppred, _, classes = setup
    out = {}
    for name, evaluate, cls, decoder, predict_fn in (
        ("jax", jax_eval.evaluate, JaxWindows, jax_get_decoder("pil"), _jax_predict_fn(jpred)),
        ("port", port_eval.evaluate, VideoWindows, get_decoder("pil"), ppred.predict_fn),
    ):
        save = str(tmp_path / name / "pred-test")
        maps, tols = evaluate(predict_fn, _windows(cls, decoder, fx, "test"), "test",
                              classes, save_pred=save, printed=False, test=True)
        with open(save + ".json") as fp:
            out[name] = (maps, tols, json.load(fp))
    (jmaps, jtols, jstore), (pmaps, ptols, pstore) = out["jax"], out["port"]
    assert ptols == jtols
    np.testing.assert_allclose(pmaps, jmaps, rtol=0, atol=1e-6)
    assert len(pstore) == len(jstore)
    for p, j in zip(pstore, jstore):
        assert {k: v for k, v in p.items() if k != "events"} == \
            {k: v for k, v in j.items() if k != "events"}
        _assert_same_events(p["events"], j["events"])
