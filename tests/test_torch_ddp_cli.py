"""The port's training CLI over 2 gloo ranks on the CPU
(``--n_devices 2 --device cpu``) against its one-process run, on
tests/test_torch_cli.py's tiny dataset (tests.fixtures: fp32, rny002_gsf,
clip 8, crop 16), batch 4 as 2 micro-batches (``--acc_grad_iter 2``), so
each rank loads one clip of every micro-batch: 2 optimizer steps an epoch.

The CLI spawns its ranks itself; their output goes to this process's
standard output, which the fixture sends to a file. Runs, each once for
the module: store mode (one process, even with ``--n_devices 2``); one
epoch in one process; one epoch over 2 ranks; a 2-rank ``--resume`` of a
copy of the one-process run; a one-process ``--resume`` of the 2-rank run.

Tolerance of the 2-rank checkpoint against the one-process one, after two
AdamW steps: the order of the fp32 sums differs (BatchNorm's moments are
the mean of the ranks' means, the gradients the mean of theirs), and the
fixture's gradient is fp32-ill-conditioned (train-mode BN over 1x1 maps,
tests/test_torch_train_step.py), so a weight whose gradient is below the
fp32 noise may take Adam's step of about lr the other way: at least 99% of
the weight elements within 1e-5 of the one-process run's (measured
99.986%; the second step's learning rate is 5e-4), the running statistics
within 5e-3 relative, floored at magnitude 1 (measured 5.0e-4: the second
step's BatchNorm sees the first step's flipped weights).
"""

import contextlib
import json
import os
import shutil
import sys

import pytest
import torch

from tdeed_tpu_torch.checkpoint import BEST, LAST
from tdeed_tpu_torch.cli import train as train_cli
from tdeed_tpu_torch.infer.predictor import SpottingPredictor
from tdeed_tpu_torch.train import step as port_step
from tests.fixtures import make_finediving_fixture, write_tiny_config
from tests.torch_port_util import N_CLASSES  # noqa: F401  (one torch thread a worker)

MODEL = "FineDiving_tiny"
CONFIG = dict(dtype="float32", batch_size=4, epoch_num_frames=64, pallas_augment=False)


@contextlib.contextmanager
def _stdout_to(path):
    """This process's standard output, and file descriptor 1, which the
    ranks it spawns inherit, go to ``path`` within."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(path, "w", buffering=1) as fp:
        os.dup2(fp.fileno(), 1)
        try:
            with contextlib.redirect_stdout(fp):
                yield
        finally:
            os.dup2(saved, 1)
            os.close(saved)


class Runs:
    def __init__(self, root):
        self.root = root
        self.fx = make_finediving_fixture(root, num_videos=2, num_frames=24)
        self.config_root = os.path.join(root, "configs")

    def run(self, name, log, *extra, num_epochs=1, store_mode="load"):
        """The CLI with the tiny config saving under <root>/<name>; its
        standard output, and its ranks', into <root>/<log>.log."""
        write_tiny_config(self.root, dict(self.fx, save_dir=os.path.join(self.root, name)),
                          store_mode=store_mode, num_epochs=num_epochs, **CONFIG)
        argv = ["--model", MODEL, "--config_root", self.config_root,
                "--data_root", self.fx["data_root"], "--no_wandb", "--device", "cpu",
                "--acc_grad_iter", "2", *extra]
        with _stdout_to(os.path.join(self.root, f"{log}.log")):
            return train_cli.main(argv)

    def dir(self, name):
        return os.path.join(self.root, name, MODEL)

    def log(self, log):
        with open(os.path.join(self.root, f"{log}.log")) as fp:
            return fp.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = Runs(str(tmp_path_factory.mktemp("ddp_cli")))
    with pytest.raises(SystemExit) as exit_:
        r.run("store", "store", "--n_devices", "2", store_mode="store")
    assert exit_.value.code in (0, None)
    made = []
    make = port_step.make_train_step

    def recording(*a, **kw):
        made.append(make(*a, **kw))
        return made[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_step, "make_train_step", recording)
        one = r.run("one", "one")
    two = r.run("two", "two", "--n_devices", "2")
    last = {k: torch.load(os.path.join(r.dir(k), LAST)) for k in ("one", "two")}
    shutil.copytree(os.path.join(r.root, "one"), os.path.join(r.root, "one_resumed"))
    shutil.copytree(os.path.join(r.root, "two"), os.path.join(r.root, "two_resumed"))
    resumed = {
        "one": r.run("one_resumed", "one_resumed", "--resume", "--n_devices", "2",
                     num_epochs=2),
        "two": r.run("two_resumed", "two_resumed", "--resume", num_epochs=2),
    }
    return dict(r=r, one=one, two=two, last=last, resumed=resumed, steps=made)


def test_store_mode_runs_in_one_process_and_stores_the_plans(runs):
    r = runs["r"]
    assert r.log("store").count("Store mode done") == 1
    assert sorted(os.listdir(r.fx["store_dir"]))


def test_two_ranks_train_two_steps_and_write_each_file_once(runs):
    """Rank 0 alone writes: the run directory holds what the one-process
    run's holds, the history one record an epoch, and the epoch and test
    lines are printed once."""
    r = runs["r"]
    assert sorted(os.listdir(r.dir("two"))) == sorted(os.listdir(r.dir("one")))
    for name in (BEST, LAST, "train_meta.json", "loss.json", "results_test.json"):
        assert name in os.listdir(r.dir("two"))
    with open(os.path.join(r.dir("two"), "train_meta.json")) as fp:
        assert [h["epoch"] for h in json.load(fp)["history"]] == [0]
    log = r.log("two")
    assert log.count("[epoch 0] train") == 1
    assert log.count("CORRECTLY FINISHED TRAINING AND INFERENCE") == 1
    assert "over 2 rank(s)" in log
    two = runs["two"]
    assert (two["start_step"], two["end_step"], two["world"]) == (0, 2, 2)
    assert (runs["one"]["end_step"], runs["one"]["world"]) == (2, 1)


def test_two_rank_checkpoint_has_bare_keys_and_matches_one_process(runs):
    """The same keys as the one-process checkpoint (no ``module.``), the
    same step count, optimizer layout and BatchNorm counters, and weights
    and running statistics at the module docstring's tolerance."""
    one, two = runs["last"]["one"], runs["last"]["two"]
    assert two["step"] == one["step"] == 2
    assert list(two["model"]) == list(one["model"])
    assert not any(k.startswith("module.") for k in two["model"])
    assert two["optimizer"]["param_groups"] == one["optimizer"]["param_groups"]
    assert two["scheduler"] == one["scheduler"]
    close = total = 0
    for k, w in one["model"].items():
        g = two["model"][k]
        if "running" in k:
            assert float(((g - w).abs() / w.abs().clamp_min(1.0)).max()) <= 5e-3, k
        elif w.is_floating_point():
            close += int(((g - w).abs() <= 1e-5).sum())
            total += w.numel()
        else:
            assert torch.equal(g, w), k
    assert close >= 0.99 * total, f"{total - close} of {total} weight elements differ"


def test_pallas_augment_reaches_the_train_step_from_the_config(runs):
    """The config's ``pallas_augment: false`` is the TrainStep's: it runs
    the plain chain."""
    assert [s.pallas_augment for s in runs["steps"]] == [False]


def test_resume_across_one_and_two_ranks(runs):
    """A one-process checkpoint resumes on 2 ranks and a 2-rank checkpoint
    in one process: each starts at step 2 (epoch 1) and ends at step 4,
    with one history record an epoch."""
    r = runs["r"]
    for name, stats in runs["resumed"].items():
        assert (stats["start_epoch"], stats["start_step"], stats["end_step"]) == (1, 2, 4)
        with open(os.path.join(r.dir(f"{name}_resumed"), "train_meta.json")) as fp:
            assert [h["epoch"] for h in json.load(fp)["history"]] == [0, 1]
    assert runs["resumed"]["one"]["world"] == 2
    assert r.log("one_resumed").count("[epoch 1] train") == 1


def test_two_rank_run_serves_through_from_run(runs):
    """SpottingPredictor.from_run loads the 2-rank run's checkpoint_best."""
    r = runs["r"]
    write_tiny_config(r.root, dict(r.fx, save_dir=os.path.join(r.root, "two")),
                      store_mode="load", **CONFIG)
    pred = SpottingPredictor.from_run(MODEL, r.config_root, r.fx["data_root"], device="cpu")
    sd = torch.load(os.path.join(r.dir("two"), BEST))
    assert all(torch.equal(v, sd[k]) for k, v in pred.model.state_dict().items())
