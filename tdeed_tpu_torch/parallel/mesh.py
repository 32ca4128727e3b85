"""Data parallelism: the process group, the rows each rank owns, the
gradient average and the serving split (port of tdeed_tpu/parallel/mesh.py).

The JAX package shards the global batch over a device mesh and lets GSPMD
insert the all-reduces, so its step's math is the global batch's. Here
each rank is a process with one device (NCCL on CUDA, gloo on the CPU), and
the global math is kept by hand:

  * every rank holds the same weights and loads its own equal shard of each
    global micro-batch (``global_rows``);
  * BatchNorm takes its moments over the global batch
    (kernels/batchnorm.py: ``TrainBatchNorm`` with the model's process
    group, set by ``distribute``), and the hard weighted CE its weight sum
    (train/losses.py);
  * the step draws the global micro-batch's randomness and keeps its rows,
    then averages the gradients once per optimizer step
    (``all_reduce_mean_``), so W ranks compute what one process computes on
    the global batch, up to the order of fp32 sums.

Serving needs no process group: one process keeps a replica of the model
on each of N devices and splits every window batch into N equal slices
(``serving_devices``, ``replicate``, ``shard_bounds``, ``gather``). Eval
rows are independent, so the gathered scores are one device's.
"""

from __future__ import annotations

import copy
import os
import socket
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

# A collective that waits longer than this fails the run: a rank that died
# must not hang the others forever (NCCL's watchdog then aborts them).
TIMEOUT = timedelta(minutes=30)
# The longest the other ranks wait for rank 0's evaluation (``host_group``).
WAIT_TIMEOUT = timedelta(hours=6)
# The environment of a torchrun launch, read by ``env_rank``.
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def env_rank() -> Tuple[int, int, int]:
    """(rank, world size, local rank) of a torchrun launch, from its
    environment; raises naming every variable that is missing."""
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"--distributed joins a torchrun launch, but {', '.join(missing)} "
            "is not set: start it with torchrun --nproc_per_node N, or use --n_devices N"
        )
    return int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]), int(os.environ["LOCAL_RANK"])


def init_distributed(device, rank: int, world: int, init_method: str = "env://",
                     backend: Optional[str] = None) -> torch.device:
    """Join the process group as ``rank`` of ``world`` on ``device``, and
    return the device.

    The backend is NCCL for a CUDA device and gloo for the CPU, unless
    ``backend`` names one (gloo over CUDA tensors stages them through the
    host, which is how two ranks can share one card). Nothing falls back: a
    missing card, a backend that cannot start or a group that does not
    form raises. One tiny all-reduce follows at once, the counterpart of
    the JAX package's ``startup_barrier``: every rank reaches it before any
    model is built, and it fails fast on a group that cannot communicate."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed: no CUDA device (torch.cuda.is_available() is False); "
                "pass --device cpu for gloo ranks on the CPU"
            )
        if device.index is None:
            raise ValueError("init_distributed: name the rank's card, e.g. cuda:0")
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"init_distributed runs on cuda or cpu, not {device}")
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    ones = torch.ones(1, device=device)
    dist.all_reduce(ones)
    if int(ones.item()) != world:
        raise RuntimeError(f"the startup all-reduce summed {int(ones.item())} ranks, not {world}")
    return device


def free_port() -> int:
    """A TCP port on localhost that is free now, for a group's rendezvous."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank(group) -> int:
    """This process's rank in ``group``; 0 for None (no group)."""
    return 0 if group is None else dist.get_rank(group)


def world(group) -> int:
    """The ranks in ``group``; 1 for None (no group)."""
    return 1 if group is None else dist.get_world_size(group)


def host_group():
    """A gloo group of every rank, on the host, for ``barrier`` and
    ``broadcast_object``; every rank calls it at the same point.

    Rank 0 evaluates alone (val mAP, the test tail) while the others wait.
    Waiting in a gloo group with its own long timeout leaves no NCCL
    collective pending, so NCCL's watchdog, bound by the training group's
    shorter timeout, has nothing to abort."""
    return dist.new_group(backend="gloo", timeout=WAIT_TIMEOUT)


def barrier(group) -> None:
    """Wait until every rank of the gloo ``group`` gets here, for at most
    WAIT_TIMEOUT; a rank that does not come is named in the error."""
    dist.monitored_barrier(group=group, timeout=WAIT_TIMEOUT, wait_all_ranks=True)


def broadcast_object(obj, group):
    """Rank 0's ``obj`` (a picklable value) on every rank of the gloo
    ``group``."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def global_rows(batch_size: int, acc_grad_iter: int, rank: int, world: int) -> List[int]:
    """The rows of each global batch of ``batch_size`` that ``rank`` of
    ``world`` loads, in the order its micro-batches take them.

    The JAX step cuts the global batch into ``acc_grad_iter`` micro-batches
    of m = B / acc_grad_iter consecutive rows (tdeed_tpu/train/step.py),
    and every micro-batch's BatchNorm statistics are the whole
    micro-batch's, so each rank takes an equal slice of every micro-batch:
    rows [i m + r m / W, i m + (r + 1) m / W) for micro-batch i. At
    acc_grad_iter 1 that is the JAX CLI's contiguous shard."""
    if batch_size % (acc_grad_iter * world):
        raise ValueError(
            f"batch_size {batch_size} does not split into {acc_grad_iter} micro-batches "
            f"over {world} ranks: it must be a multiple of acc_grad_iter x ranks = "
            f"{acc_grad_iter * world}"
        )
    m = batch_size // acc_grad_iter
    per = m // world
    return [i * m + rank * per + j for i in range(acc_grad_iter) for j in range(per)]


def distribute(model: nn.Module, group=None) -> nn.Module:
    """Make ``model`` take its BatchNorm statistics over the global batch of
    ``group`` (the default group): sets ``process_group`` on the model,
    which the train and val steps read, and on each SplitBatchNorm.
    Returns the model. Eval mode communicates nothing."""
    from tdeed_tpu_torch.models.common import SplitBatchNorm

    group = dist.group.WORLD if group is None else group
    model.process_group = group
    for m in model.modules():
        if isinstance(m, SplitBatchNorm):
            m.process_group = group
    return model


def group_of(model: nn.Module):
    """The process group ``distribute`` gave ``model``, None without one or
    with one of a single rank."""
    group = getattr(unwrap(model), "process_group", None)
    return group if group is not None and dist.get_world_size(group) > 1 else None


def unwrap(model: nn.Module) -> nn.Module:
    """The bare module under a DistributedDataParallel or DataParallel
    wrapper (the counterpart of ``host_replica``): checkpoints and
    ``two_heads`` read it, so state dict keys never carry ``module.``."""
    while isinstance(model, (nn.parallel.DistributedDataParallel, nn.DataParallel)):
        model = model.module
    return model


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group) -> None:
    """Replace each tensor by its mean over the ranks of ``group``, in
    place: one all-reduce for each dtype, over the tensors flattened into
    one buffer."""
    world_size = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= world_size
        offset = 0
        for t in ts:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


# -- serving over several devices in one process ----------------------------


def serving_devices(device, n_devices: Optional[int]) -> List[torch.device]:
    """The devices of ``n_devices`` replicas: cuda:0..N-1 for a CUDA
    ``device`` (N above the card count raises), N times the CPU for the
    CPU. One device, unchanged, for ``n_devices`` None or 1."""
    device = torch.device(device)
    n = n_devices or 1
    if n < 1:
        raise ValueError(f"n_devices must be at least 1, got {n}")
    if n == 1:
        return [device]
    if device.type == "cpu":
        return [device] * n
    if device.type != "cuda":
        raise ValueError(f"serving runs on cuda or cpu, not {device}")
    if device.index not in (None, 0):
        raise ValueError(f"n_devices={n} places the replicas on cuda:0..{n - 1}; got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is False); "
                           "pass device='cpu' to serve on the CPU")
    count = torch.cuda.device_count()
    if n > count:
        raise ValueError(f"n_devices={n} but this machine has {count} CUDA device(s)")
    return [torch.device("cuda", i) for i in range(n)]


def replicate(model: nn.Module, devices: Sequence[torch.device]) -> List[nn.Module]:
    """``model`` (on ``devices[0]``) and a copy of it on each other device."""
    return [model] + [copy.deepcopy(model).to(d) for d in devices[1:]]


def shard_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """[start, stop) of ``parts`` equal consecutive slices of ``n`` rows."""
    if n % parts:
        raise ValueError(f"batch {n} does not split into {parts} equal slices")
    per = n // parts
    return [(i * per, (i + 1) * per) for i in range(parts)]


def gather(parts: Sequence[torch.Tensor], device: torch.device) -> torch.Tensor:
    """The slices concatenated in order on ``device``; one slice passes
    through as it is."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(device) for p in parts])
