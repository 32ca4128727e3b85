"""The port's own config module (tdeed_tpu_torch/config.py) against the JAX
package's (tdeed_tpu/config.py): every shipped config loads to the same
fields and values in both, with overrides too."""

import dataclasses
from pathlib import Path

import pytest

from tdeed_tpu import config as jax_config
from tdeed_tpu_torch import config as port_config

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("*/*.json"))
DERIVED = ("num_classes_bg", "backbone", "shift_mode", "dataset_len", "micro_batch_size")


def _same(port_cfg, jax_cfg):
    assert type(port_cfg).__name__ == type(jax_cfg).__name__
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(jax_cfg)
    for name in DERIVED:
        assert getattr(port_cfg, name) == getattr(jax_cfg, name), name


def test_every_shipped_config_is_found():
    assert len(CONFIGS) == 14


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_shipped_config_loads_the_same_in_both_packages(path):
    root = str(REPO / "configs")
    _same(port_config.load_config(path.stem, config_root=root),
          jax_config.load_config(path.stem, config_root=root))
    _same(port_config.load_config(str(path)), jax_config.load_config(str(path)))


def test_overrides_and_defaults_match():
    root = str(REPO / "configs")
    kw = dict(config_root=root, dtype="float32", clip_len=8)
    got = port_config.load_config("FineDiving_small", **kw)
    _same(got, jax_config.load_config("FineDiving_small", **kw))
    assert got.dtype == "float32" and got.clip_len == 8
    _same(port_config.TDEEDConfig(), jax_config.TDEEDConfig())
    assert [f.name for f in dataclasses.fields(port_config.TDEEDConfig)] == [
        f.name for f in dataclasses.fields(jax_config.TDEEDConfig)]
    assert port_config.config_path_for_model(root, "Tennis_big") == \
        jax_config.config_path_for_model(root, "Tennis_big")
