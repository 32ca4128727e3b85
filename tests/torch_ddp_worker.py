"""Rank processes for the data-parallel tests of the PyTorch port
(tests/test_torch_ddp*.py).

Each test file spawns its ranks once (``start``): W gloo processes on the
CPU, joined over tcp://localhost, each running one function of this
module over inputs the test wrote with ``torch.save`` and writing its
results beside them. This module imports torch and the port only, so a
rank's ``sys.modules`` shows whether the port pulled in JAX.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import torch
import torch.multiprocessing as mp

from tdeed_tpu_torch.models.common import SplitBatchNorm
from tdeed_tpu_torch.models.regnet import RegNetY
from tdeed_tpu_torch.models.tdeed import TDEED
from tdeed_tpu_torch.parallel import mesh
from tdeed_tpu_torch.train import step as port_step
from tdeed_tpu_torch.train.losses import weighted_ce_hard
from tdeed_tpu_torch.train.schedule import make_optimizer
from tdeed_tpu_torch.train.step import make_train_step

WORLD = 2
N_CLASSES = 4
NC_BG = N_CLASSES + 1
T, CROP = 8, 32
MODEL = dict(n_layers=1, sgp_ks=3, sgp_r=2, radi_displacement=2)
LR, WARM, COS = 8e-4, 2, 10
SEED = 11  # of the step's draws
# the rny002 trunks the port builds, by feature_arch: their shift_mode
TRUNKS = {"gsf": "gsf", "gsm": "gsm", "rny002": None}
TRUNK_CLIP = 2  # the float64 trunk cases' clip length
# the train-step cases: (name, mixup, acc_grad_iter, dtype, replaces the
# photometric output with the test's "augmented" tensors, the trunk)
STEP_CASES = (
    ("mixup-acc1", True, 1, torch.float32, False, "gsf"),
    ("mixup-acc2", True, 2, torch.float32, False, "gsf"),
    ("plain-acc1", False, 1, torch.float32, False, "gsf"),
    ("plain-acc2", False, 2, torch.float32, False, "gsf"),
    ("mixup-acc2-float64", True, 2, torch.float64, False, "gsf"),
    ("plain-acc1-jax-augmented", False, 1, torch.float32, True, "gsf"),
    ("gsm-mixup-acc2", True, 2, torch.float32, False, "gsm"),
    ("rny002-plain-acc1", False, 1, torch.float32, False, "rny002"),
)
JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "tdeed_tpu")


def start(fn, root: Path, world: int = WORLD):
    """Start ``world`` ranks running ``fn(rank, world, port, root)``; returns
    the processes' context (``join()`` it)."""
    return mp.start_processes(fn, args=(world, mesh.free_port(), str(root)), nprocs=world,
                              join=False, start_method="spawn")


def join(procs, timeout: float = 300.0) -> None:
    """Wait for every rank, raising what a rank raised."""
    import time

    end = time.monotonic() + timeout
    while not procs.join(timeout=1.0):
        if time.monotonic() > end:
            for p in procs.processes:
                p.kill()
            raise TimeoutError(f"the ranks did not finish within {timeout} s")


def jax_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in JAX_MODULES)


def make_step(state_dict, dtype, mixup: bool, acc_grad_iter: int, distributed: bool,
              trunk: str = "gsf"):
    """The tiny train step of the tests: the rny002 ``trunk`` (a TRUNKS
    key), clip 8, crop 32, n_layers 1, from ``state_dict``, in ``dtype``,
    over the default group when ``distributed``."""
    model = TDEED(N_CLASSES, T, dtype=dtype, shift_mode=TRUNKS[trunk], **MODEL)
    if dtype == torch.float64:
        model = model.double()
        state_dict = {k: v.double() if v.is_floating_point() else v
                      for k, v in state_dict.items()}
    model.load_state_dict(state_dict, strict=True)
    if distributed:
        mesh.distribute(model)
    opt, sched = make_optimizer(model.parameters(), LR, WARM, COS)
    return make_train_step(model, opt, sched, crop_dim=CROP, num_classes_bg=NC_BG,
                           mixup=mixup, radi_displacement=2, acc_grad_iter=acc_grad_iter,
                           seed=SEED)


def run_step(step, batch, augmented=None):
    """One step on ``batch``; ``augmented`` (one tensor per micro-batch)
    replaces the photometric output. Returns (loss, the model's state
    dict, its gradients, the step's draws as dicts)."""
    draws = step.draw(batch)
    original = port_step.train_preprocess
    if augmented is not None:
        outs = iter(augmented)
        port_step.train_preprocess = lambda frames, params: next(outs)
    try:
        loss = float(step(batch, draws)["loss"])
    finally:
        port_step.train_preprocess = original
    grads = {n: p.grad.clone() for n, p in step.model.named_parameters() if p.grad is not None}
    state = {k: v.clone() for k, v in step.model.state_dict().items()}
    return loss, state, grads, [vars(d) for d in draws]


def rows(x, rank: int, world: int, acc_grad_iter: int = 1):
    """``rank``'s rows of the global batch ``x`` (parallel.mesh.global_rows)."""
    return x[mesh.global_rows(x.shape[0], acc_grad_iter, rank, world)]


def bn_function_run(case, x, c, group=None):
    """kernels.batchnorm.batch_norm_train with ReLU on the (B, C, T, H, W)
    view of ``x`` (B, T, H, W, C), over ``group``'s global batch when given,
    under the loss mean(y * c): y, the statistics, the gradients of x and
    the parameters and the running statistics."""
    from tdeed_tpu_torch.kernels.batchnorm import batch_norm_train

    x = x.clone().requires_grad_(True)
    weight, bias = (case[k].clone().requires_grad_(True) for k in ("weight", "bias"))
    running = (case["running_mean"].clone(), case["running_var"].clone(), torch.tensor(0))
    y, stats = batch_norm_train(x.permute(0, 4, 1, 2, 3), weight, bias, 1e-5, True, running,
                                group)
    (y * c.permute(0, 4, 1, 2, 3)).mean().backward()
    return {"y": y.detach().permute(0, 2, 3, 4, 1), "stats": stats, "x_grad": x.grad,
            "weight_grad": weight.grad, "bias_grad": bias.grad, "running_mean": running[0],
            "running_var": running[1], "batches": running[2]}


def make_trunk(trunk: str) -> RegNetY:
    """The float64 rny002 ``trunk`` (a TRUNKS key) over clips of TRUNK_CLIP."""
    return RegNetY("rny002", clip_len=TRUNK_CLIP, shift_mode=TRUNKS[trunk]).double()


def trunk_run(trunk: str, state_dict, x, c, group=None):
    """The float64 ``trunk`` from ``state_dict``, over ``group``'s global
    batch when given, in train mode on frames ``x`` (N, 3, H, W): its
    features, input gradient, parameter gradients and state under the
    loss sum(features * c)."""
    trunk = make_trunk(trunk)
    trunk.load_state_dict(state_dict, strict=True)
    if group is not None:
        mesh.distribute(trunk, group)
    x = x.contiguous(memory_format=torch.channels_last).requires_grad_(True)
    y = trunk.train()(x)
    (y * c).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad,
            "grads": {n: p.grad for n, p in trunk.named_parameters()},
            "state": trunk.state_dict()}


def step_cases(rank: int, world: int, port: int, root: str) -> None:
    """The cases of tests/test_torch_ddp.py on one rank."""
    torch.set_num_threads(1)
    mesh.init_distributed("cpu", rank, world, f"tcp://localhost:{port}")
    try:
        inputs = torch.load(os.path.join(root, "inputs.pt"))
        out = {}

        # BatchNorm over the global batch, float64
        bn = SplitBatchNorm(inputs["bn_x"].shape[1]).double()
        bn.load_state_dict(inputs["bn_state"])
        mesh.distribute(bn)
        x = rows(inputs["bn_x"], rank, world).clone().requires_grad_(True)
        y = bn(x)
        (y * rows(inputs["bn_c"], rank, world)).mean().backward()
        out["bn"] = {"y": y.detach(), "x_grad": x.grad, "weight_grad": bn.weight.grad,
                     "bias_grad": bn.bias.grad, "running_mean": bn.running_mean,
                     "running_var": bn.running_var}

        # the training BatchNorm Function with its ReLU over the GSF gate's
        # (B, C, T, H, W) view, float64
        out["bn_fn"] = bn_function_run(inputs["bnf"], rows(inputs["bnf"]["x"], rank, world),
                                       rows(inputs["bnf"]["c"], rank, world),
                                       torch.distributed.group.WORLD)

        # the hard weighted CE, float64
        logits = rows(inputs["ce_logits"], rank, world).clone().requires_grad_(True)
        loss = weighted_ce_hard(logits, rows(inputs["ce_labels"], rank, world),
                                inputs["ce_weights"], torch.distributed.group.WORLD)
        loss.backward()
        out["ce"] = {"loss": loss.detach(), "grad": logits.grad}

        # each trunk over the global batch, float64
        for trunk, state in inputs["trunk_states"].items():
            out[f"trunk-{trunk}"] = trunk_run(
                trunk, state, rows(inputs["trunk_x"], rank, world),
                rows(inputs["trunk_c"], rank, world), torch.distributed.group.WORLD)

        # train steps
        for name, mixup, acc, dtype, replaced, trunk in STEP_CASES:
            batch = {k: rows(v, rank, world, acc) for k, v in inputs["batch"].items()}
            step = make_step(inputs["states"][trunk], dtype, mixup, acc, distributed=True,
                             trunk=trunk)
            augmented = None
            if replaced:
                augmented = [rows(inputs["augmented"], rank, world)]
            loss, state, grads, draws = run_step(step, batch, augmented)
            out[name] = {"loss": loss, "state": state, "grads": grads, "draws": draws}
        out["jax_modules"] = jax_modules()
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        mesh.shutdown()
