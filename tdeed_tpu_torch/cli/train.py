"""Training CLI of the port (port of tdeed_tpu/cli/train.py).

Orchestration parity (ref: train_tdeed.py:90-315): seed -> config ->
store/load clip plans -> model/optimizer -> epoch loop with best-checkpoint
selection on val loss or val mAP -> restore best -> test-split inference +
metrics. Around the reference: the threaded decode pipeline with pinned
device prefetch, bf16 compute, micro-batches (``--acc_grad_iter``), and
checkpoints with step-level resume. A config with ``pretrain`` trains
jointly on two datasets (SoccerNet Ball with SoccerNet): the FC2 double
head, 50/50 tagged sampling and per-clip loss routing; SoccerNet's val mAP
is ``metrics.soccernet.val_map_sn`` and the SoccerNet test tail adds the
official scorers (``evaluate_sn_official``, ``evaluate_snb``).

Usage:
    python -m tdeed_tpu_torch.cli.train --model FineDiving_small
        [--acc_grad_iter N] [--seed S] [--resume] [--no_wandb]
        [--device cuda|cpu] [--n_devices N]
    torchrun --nproc_per_node N -m tdeed_tpu_torch.cli.train
        --model FineDiving_small --distributed [...]

It runs on the CUDA device unless ``--device cpu`` is given; without a
card it raises, it never falls back.

Data parallelism (parallel/mesh.py): ``--n_devices N`` starts N ranks
itself, on cuda:0..N-1 (or N gloo ranks on the CPU with ``--device cpu``);
``--distributed`` joins a torchrun launch as the rank its environment
names (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), on
cuda:LOCAL_RANK. Both then run the same code: NCCL on the card, gloo on
the CPU, no fallback. ``batch_size`` is the global batch; each rank loads
its rows of every global micro-batch, so it must be a multiple of
acc_grad_iter x ranks. BatchNorm statistics, the loss and the gradients
are the global batch's. Rank 0 alone writes the checkpoints, the meta
file, the logs and the interrupt save, and runs the val mAP and the test
tail while the other ranks wait; every rank reads the same checkpoint on
``--resume``, so a run resumes on any number of ranks. Each rank runs its
own loader threads and its own frame cache of ``decode_cache_mb``.
Store mode writes the plans from one process and exits 0.
"""

from __future__ import annotations

import argparse
import os
import random
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from tdeed_tpu_torch.config import load_config
from tdeed_tpu_torch.models.tdeed import check_supported
from tdeed_tpu_torch.parallel import mesh

EVAL_SPLITS = ["test"]  # ref: train_tdeed.py:30


def get_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model", "-m", required=True,
                        help="<DatasetPrefix>_<name>, resolves configs/<Prefix>/<model>.json")
    parser.add_argument("--acc_grad_iter", type=int, default=1)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--config_root", default="configs")
    parser.add_argument("--data_root", default="data",
                        help="dataset metadata root (train/val/test.json + class.txt)")
    parser.add_argument("--resume", action="store_true",
                        help="resume from checkpoint_last in save_dir")
    parser.add_argument("--n_devices", type=int, default=None,
                        help="train data-parallel over N ranks this command starts: "
                             "cuda:0..N-1, or N CPU ranks with --device cpu")
    parser.add_argument("--no_wandb", action="store_true")
    parser.add_argument(
        "--profile_dir", default=None,
        help="capture a torch.profiler trace of training steps 1-4 into this "
             "directory (trace.json, for Perfetto or chrome://tracing)",
    )
    parser.add_argument("--distributed", action="store_true",
                        help="join a torchrun launch as one data-parallel rank "
                             "(cuda:LOCAL_RANK, or the CPU with --device cpu)")
    parser.add_argument("--device", default="cuda",
                        help="where the model runs (default: the CUDA device)")
    return parser.parse_args(argv)


def seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def labels_root_for(data_root: str, dataset: str) -> Optional[str]:
    """SN/SNB external label tree via labels_path.txt indirection
    (ref: train_tdeed.py:102-107)."""
    path = os.path.join(data_root, dataset, "labels_path.txt")
    if os.path.exists(path):
        with open(path) as fp:
            return fp.read().strip()
    return None


def refuse_waiting(cfg, args) -> None:
    """Raise, before anything is read or written, for a launch the CLI
    cannot run: --distributed with --n_devices, more ranks than cards, a
    batch that does not split into acc_grad_iter micro-batches over the
    ranks (ValueError each); then for a config the model cannot build
    (check_supported)."""
    n = args.n_devices or 1
    if args.n_devices is not None and args.n_devices < 1:
        raise ValueError(f"--n_devices must be at least 1, got {args.n_devices}")
    if args.distributed and n > 1:
        raise ValueError("--distributed takes its ranks from torchrun; do not pass --n_devices")
    if n > 1 and torch.device(args.device).type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > count:
            raise ValueError(f"--n_devices {n} but this machine has {count} CUDA device(s)")
    mesh.global_rows(cfg.batch_size, cfg.acc_grad_iter, 0, n)  # raises if B does not split
    check_supported(cfg)


def build_samplers(cfg, args, classes, decoder, classes2=None, cache=None):
    """Store-or-load the clip plans and build train/val samplers
    (ref: dataset/datasets.py:19-96). In store mode this stores the train
    and val plans, and the pretrain dataset's with ``pretrain``, and exits
    0, like the reference (ref: train_tdeed.py:120-122). With
    ``pretrain`` each sampler is a JointSampler over the two datasets."""
    from tdeed_tpu_torch.data.clips import load_plan, plan_clips, store_plan
    from tdeed_tpu_torch.data.loader import ClipSampler, JointSampler
    from tdeed_tpu_torch.data.registry import get_spec

    def prepare(dataset, frame_dir, store_dir, cls, splits):
        dspec = get_spec(dataset)
        lroot = labels_root_for(args.data_root, dataset)
        plans = {}
        for split in splits:
            if cfg.store_mode == "store":
                plan = plan_clips(
                    dataset,
                    os.path.join(args.data_root, dataset, f"{split}.json"),
                    frame_dir,
                    cls,
                    cfg.clip_len,
                    dspec.train_stride,
                    dspec.train_overlap,
                    cfg.radi_displacement,
                    labels_root=lroot,
                )
                store_plan(plan, store_dir, cfg.clip_len, cfg.radi_displacement, split)
                print(f"Stored {len(plan)} {dataset}/{split} clips -> {store_dir}")
            else:
                plan = load_plan(store_dir, cfg.clip_len, cfg.radi_displacement, split)
            plans[split] = plan
        return plans

    tr, va = cfg.train_split, cfg.val_split
    plans = prepare(cfg.dataset, cfg.frame_dir, cfg.store_dir, classes, (tr, va))
    plans2 = None
    if cfg.pretrain is not None:
        # The pretrain dataset (SN) has no challenge split variants; it
        # always trains on its plain train/val metadata.
        plans2 = prepare(cfg.pretrain.dataset, cfg.pretrain.frame_dir or cfg.frame_dir,
                         cfg.pretrain.store_dir or cfg.store_dir, classes2, ("train", "val"))
    if cfg.store_mode == "store":
        print("Store mode done; rerun with store_mode='load'.")
        sys.exit(0)

    def sampler(plan, dataset, mixup):
        return ClipSampler(plan, cfg.clip_len, get_spec(dataset).train_stride,
                           cfg.radi_displacement, mixup, decoder=decoder, cache=cache)

    train = sampler(plans[tr], cfg.dataset, cfg.mixup)
    val = sampler(plans[va], cfg.dataset, False)
    if plans2 is not None:
        # Joint 50/50 sampling with dataset tags (ref: dataset/frame.py:640-663)
        train = JointSampler(train, sampler(plans2["train"], cfg.pretrain.dataset, cfg.mixup))
        val = JointSampler(val, sampler(plans2["val"], cfg.pretrain.dataset, False))
    return train, val, labels_root_for(args.data_root, cfg.dataset)


def main(argv=None) -> Dict:
    """Run the CLI. Returns what the run measured (rank 0's, over several
    ranks): the step it started from and ended at, per epoch the optimizer
    steps and the seconds of training, of waiting for batches inside it,
    of the val loss, the val mAP and the checkpoint save, then the test
    evaluation's seconds and the frame cache's statistics, and the
    SoccerNet scorers' results ("soccernet", by split) where the dataset
    has them."""
    args = get_args(argv)
    cfg = load_config(args.model, args.config_root, acc_grad_iter=args.acc_grad_iter)
    refuse_waiting(cfg, args)
    if args.distributed:
        rank, world, local_rank = mesh.env_rank()
        mesh.global_rows(cfg.batch_size, cfg.acc_grad_iter, rank, world)
        if cfg.store_mode == "store":
            if rank:  # rank 0 writes the plans
                sys.exit(0)
            return run(args, cfg)
        device = "cpu" if torch.device(args.device).type == "cpu" else f"cuda:{local_rank}"
        return run(args, cfg, rank, world, device, "env://")
    if (args.n_devices or 1) > 1 and cfg.store_mode != "store":
        return spawn(argv, args.n_devices)
    return run(args, cfg)


def spawn(argv, n: int) -> Dict:
    """Run the CLI as ``n`` ranks in processes started here (spawned, so
    each imports the port afresh), joined over tcp://localhost, and return
    rank 0's result. A rank that raises ends the others, and the error is
    raised here. CPU ranks share this process's threads."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = mp.start_processes(
        _spawned_rank, args=(argv, n, mesh.free_port(), torch.get_num_threads(), results),
        nprocs=n, join=False, start_method="spawn",
    )
    stats = None
    while not procs.join(timeout=0.5):  # raises if a rank failed
        if not results.empty():
            stats = results.get()
    if not results.empty():
        stats = results.get()
    return stats


def _spawned_rank(rank: int, argv, world: int, port: int, threads: int, results) -> None:
    args = get_args(argv)
    cfg = load_config(args.model, args.config_root, acc_grad_iter=args.acc_grad_iter)
    device = args.device
    if torch.device(device).type == "cpu":
        torch.set_num_threads(max(1, threads // world))
    else:
        device = f"cuda:{rank}"
    stats = run(args, cfg, rank, world, device, f"tcp://localhost:{port}")
    if rank == 0:
        results.put(stats)


def run(args, cfg, rank: int = 0, world: int = 1, device=None,
        init_method: Optional[str] = None) -> Dict:
    """Train and evaluate as ``rank`` of ``world`` on ``device`` (default
    ``args.device``): one process without ``init_method``, else a rank of
    the group formed there (of one rank too), left again at the end."""
    if init_method is None:
        return _train(args, cfg, args.device if device is None else device)
    device = mesh.init_distributed(device, rank, world, init_method)
    try:
        return _train(args, cfg, device, rank, world, mesh.host_group())
    finally:
        mesh.shutdown()


def _train(args, cfg, device, rank: int = 0, world: int = 1, waits=None) -> Dict:
    """The run itself; see ``run``. ``waits`` is the host group the other
    ranks wait in while rank 0 evaluates, None without a process group."""
    seed_everything(args.seed)
    main_rank = rank == 0

    from tdeed_tpu_torch.checkpoint import BEST, LAST, CheckpointManager, load_backbone, save_state
    from tdeed_tpu_torch.data import frames as frame_io
    from tdeed_tpu_torch.data.loader import BatchLoader, FrameCache, device_prefetch
    from tdeed_tpu_torch.data.registry import get_spec, load_classes
    from tdeed_tpu_torch.infer.evaluate import evaluate
    from tdeed_tpu_torch.infer.windows import VideoWindows
    from tdeed_tpu_torch.metrics import soccernet
    from tdeed_tpu_torch.models.tdeed import build_model, two_heads_for
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_predict_step, make_train_step, make_val_step
    from tdeed_tpu_torch.utils.logging import MetricsLogger
    from tdeed_tpu_torch.utils.profiling import trace

    spec = get_spec(cfg.dataset)
    classes = load_classes(os.path.join(args.data_root, cfg.dataset, "class.txt"))
    assert len(classes) == cfg.num_classes, (len(classes), cfg.num_classes)
    two_heads = two_heads_for(cfg)
    classes2 = None
    if cfg.pretrain is not None:
        classes2 = load_classes(
            os.path.join(args.data_root, cfg.pretrain.dataset, "class.txt"))
    # Looked up through the module when the run starts, so a caller can put
    # another reader in its place (a machine without cv2 or PIL).
    decoder = frame_io.get_decoder(cfg.decoder)

    # One decoded-frame LRU, shared by the train/val samplers AND the eval
    # windows (same decoder; plans and eval windows overlap heavily).
    frame_cache = (
        FrameCache(cfg.decode_cache_mb << 20) if cfg.decode_cache_mb > 0 else None
    )
    train_sampler, val_sampler, labels_root = build_samplers(
        cfg, args, classes, decoder, classes2, cache=frame_cache
    )

    # --- model / optimizer ---------------------------------------------
    model = build_model(cfg, two_heads, device=device)
    if cfg.backbone_ckpt:
        # ImageNet-pretrained trunk (ref: model/model.py:37-46 builds it with
        # timm pretrained=True); here a timm state dict file
        load_backbone(model, cfg.backbone_ckpt)
        print(f"Loaded pretrained backbone <- {cfg.backbone_ckpt}")
    device = next(model.parameters()).device
    if waits is not None:
        # every rank starts from rank 0's weights and statistics, and takes
        # its BatchNorm moments over the global batch
        for t in model.state_dict().values():
            torch.distributed.broadcast(t, src=0)
        mesh.distribute(model)
        if cfg.pallas_augment is not False and device.type == "cuda":
            # one nvcc for all ranks: rank 0 builds the kernel, the others
            # load the library it wrote (kernels/build.py)
            from tdeed_tpu_torch.kernels.build import load

            if main_rank:
                load("photometric")
            mesh.barrier(waits)
            load("photometric")
    crop = cfg.crop_dim
    if crop is None and cfg.acc_grad_iter == 1:
        # Full-frame (crop_dim -1) training, e.g. SoccerNet Ball at 796x448.
        # The advice is the JAX package's, measured on a TPU, where the plain
        # step fits memory only through rematerialization; on the card it is
        # not measured.
        print("hint: full-frame training with acc_grad_iter=1; on a TPU "
              "--acc_grad_iter 2 measured 19% faster at this geometry "
              "(see configs/README.md)")
    steps_per_epoch = cfg.dataset_len // cfg.batch_size  # optimizer steps
    opt, sched = make_optimizer(
        model.parameters(),
        cfg.learning_rate,
        warmup_steps=cfg.warm_up_epochs * steps_per_epoch,
        cosine_steps=(cfg.num_epochs - cfg.warm_up_epochs) * steps_per_epoch,
    )
    train_step = make_train_step(
        model, opt, sched, crop_dim=crop, num_classes_bg=cfg.num_classes_bg,
        mixup=cfg.mixup, radi_displacement=cfg.radi_displacement,
        acc_grad_iter=cfg.acc_grad_iter, seed=args.seed + 7,
        pallas_augment=cfg.pallas_augment,
    )
    val_step = make_val_step(
        model, crop_dim=crop, num_classes_bg=cfg.num_classes_bg,
        radi_displacement=cfg.radi_displacement,
    )
    predict_step = make_predict_step(
        model, crop_dim=crop, radi_displacement=cfg.radi_displacement
    )

    def predict_fn(frames, hflip=False):
        return predict_step(frames, hflip)[1]

    # --- data loaders ---------------------------------------------------
    # Each rank loads its rows of the same global batches (sample RNGs keyed
    # by global row), so the ranks' union is the one-process epoch: the
    # train rows a slice of every micro-batch, the val rows a contiguous
    # shard (the val step takes the whole batch at once).
    train_rows = mesh.global_rows(cfg.batch_size, cfg.acc_grad_iter, rank, world)
    val_rows = mesh.global_rows(cfg.batch_size, 1, rank, world)
    train_loader = BatchLoader(
        train_sampler, len(train_rows), cfg.dataset_len,
        num_workers=max(4, cfg.num_workers), seed=args.seed,
        global_batch_size=cfg.batch_size, rows=train_rows,
    )
    val_loader = BatchLoader(
        val_sampler, len(val_rows), cfg.dataset_len // 4,  # ref: datasets.py:49
        num_workers=max(4, cfg.num_workers), seed=args.seed + 100_000,
        global_batch_size=cfg.batch_size, rows=val_rows,
    )
    val_data_frames = None
    if main_rank and cfg.criterion == "map" and cfg.dataset != "soccernet":
        val_data_frames = VideoWindows(
            cfg.dataset,
            os.path.join(args.data_root, cfg.dataset, f"{cfg.val_split}.json"),
            cfg.frame_dir,
            cfg.clip_len,
            overlap_len=0,
            stride=spec.eval_stride,
            labels_root=labels_root,
            decoder=decoder,
            cache=frame_cache,
        )

    ckpt = CheckpointManager(cfg.save_dir or os.path.join("checkpoints", cfg.model))
    logger = MetricsLogger(ckpt.save_dir, cfg, enable_wandb=not args.no_wandb and main_rank)

    start_epoch = 0
    resume_batch = 0
    if not args.resume and not cfg.only_test and main_rank:
        # Fresh run in a reused save_dir: a stale best_criterion/history
        # would suppress checkpoint_best for the whole run and the final
        # eval would score the OLD weights.
        ckpt.save_meta({"epoch": -1, "best_criterion": None, "history": []})
    if args.resume:
        train_step, start_epoch = ckpt.restore_last(train_step)
        # Step-level resume: the step count places the loader (batch b of
        # epoch e is a pure function of (seed, e, b)) and seeds the step's
        # draws, so an interrupt-saved mid-epoch checkpoint continues from
        # the exact next batch (the reference restarts from scratch).
        steps_done = train_step.step
        if steps_per_epoch > 0 and steps_done > 0:
            start_epoch = steps_done // steps_per_epoch
            resume_batch = steps_done % steps_per_epoch
        if main_rank:
            print(f"Resumed at epoch {start_epoch}, batch {resume_batch} "
                  f"(step {steps_done})")
    best = ckpt.load_meta().get("best_criterion") if args.resume else None
    if best is None:
        best = float("inf") if cfg.criterion == "loss" else 0.0

    def placed(iterator):
        # two batches in flight: decode/assembly and the host-to-device
        # copies overlap device compute
        return device_prefetch(iterator, device, depth=2)

    profiled = {"done": args.profile_dir is None or not main_rank}
    stats = {"start_epoch": start_epoch, "start_batch": resume_batch,
             "start_step": train_step.step, "epochs": []}

    def run_train_epoch(epoch: int, start_batch: int = 0):
        """(mean loss, optimizer steps, seconds spent waiting for batches)."""
        # Loss scalars stay on the device until the epoch ends: a float() per
        # step would wait for the device and stall the prefetch.
        losses = []
        waited = 0.0
        capture = None

        def end_capture():
            float(losses[-1])  # wait for the traced steps
            capture.__exit__(None, None, None)
            profiled["done"] = True
            print(f"profiler trace -> {args.profile_dir}")

        batches = placed(train_loader.epoch(epoch, start_batch=start_batch))
        while True:
            t0 = time.perf_counter()
            batch = next(batches, None)
            waited += time.perf_counter() - t0
            if batch is None:
                break
            if not profiled["done"] and len(losses) == 1:  # skip the first step
                capture = trace(args.profile_dir, device)
                capture.__enter__()
            losses.append(train_step(batch)["loss"])
            if capture is not None and len(losses) == 5:
                end_capture()
                capture = None
        if capture is not None:  # short epoch: close the span
            end_capture()
        if not losses:
            return 0.0, 0, waited
        return float(torch.stack(losses).mean()), len(losses), waited

    def run_val_epoch(epoch: int) -> float:
        losses = [val_step(batch)["loss"] for batch in placed(val_loader.epoch(epoch))]
        if not losses:
            return 0.0
        return float(torch.stack(losses).mean())

    def _train_epochs():
        nonlocal best, resume_batch
        for epoch in range(start_epoch, cfg.num_epochs):
            t0 = time.time()
            train_loss, n_steps, waited = run_train_epoch(epoch, start_batch=resume_batch)
            resume_batch = 0
            t1 = time.time()
            val_loss = run_val_epoch(epoch)
            t2 = time.time()

            val_map = None
            is_best = False
            if cfg.criterion == "loss":
                is_best = val_loss < best
                if is_best:
                    best = val_loss
            elif epoch >= cfg.start_val_epoch:  # ref: train_tdeed.py:182-199
                if cfg.dataset == "soccernet" and main_rank:
                    val_map = soccernet.val_map_sn(
                        predict_fn, cfg, args.data_root, labels_root,
                        decoder=decoder, cache=frame_cache,
                    )
                elif main_rank:
                    val_map = evaluate(
                        predict_fn,
                        val_data_frames,
                        "VAL",
                        classes,
                        printed=False,
                        test=False,
                        augment=False,
                        labels_root=labels_root,
                    )
                if waits is not None:  # rank 0 alone evaluates; every rank takes its mAP
                    mesh.barrier(waits)
                    val_map = mesh.broadcast_object(val_map, waits)
                is_best = val_map > best
                if is_best:
                    best = val_map
            t3 = time.time()

            record = {
                "epoch": epoch,
                "train": train_loss,
                "val": val_loss,
                "val_mAP": val_map,
                "train_time": t1 - t0,
                "val_time": t2 - t1,
            }
            if main_rank:
                logger.log_epoch(record)
                print(
                    f"[epoch {epoch}] train {train_loss:.4f} val {val_loss:.4f}"
                    + (f" val_mAP {val_map:.4f}" if val_map is not None else "")
                    + (" *best*" if is_best else "")
                )
                ckpt.save_epoch(train_step, epoch, record, is_best, best)
            t4 = time.time()
            frames_per_s = cfg.batch_size * cfg.clip_len * n_steps / (t1 - t0)
            if main_rank:
                print(f"[epoch {epoch}] {n_steps} optimizer steps in {t1 - t0:.3f} s "
                      f"({frames_per_s:.0f} train frames/s with the loader over {world} "
                      f"rank(s), {waited / (t1 - t0):.1%} of it waiting for batches); "
                      f"val loss {t2 - t1:.3f} s, val mAP {t3 - t2:.3f} s, "
                      f"checkpoint {t4 - t3:.3f} s")
            stats["epochs"].append({
                "epoch": epoch, "steps": n_steps, "train_s": t1 - t0,
                "wait_s": waited, "val_loss_s": t2 - t1, "val_map_s": t3 - t2,
                "save_s": t4 - t3,
            })

    if cfg.only_test and not os.path.exists(os.path.join(ckpt.save_dir, BEST)):
        # Fail fast: only_test with no trained checkpoint would silently
        # launch a full training run before the eval the user asked for.
        raise SystemExit(f"only_test=True but no {BEST} under {ckpt.save_dir}")
    if not cfg.only_test:
        try:
            _train_epochs()
        except KeyboardInterrupt:
            # Graceful interrupt: persist the in-flight state so --resume
            # continues from here (the reference restarts from scratch).
            if main_rank:
                print("interrupted: saving checkpoint_last for --resume")
                save_state(os.path.join(ckpt.save_dir, LAST), train_step)
            raise
    stats["end_step"] = train_step.step
    stats["world"] = world

    # --- test: rank 0 alone, the others wait ------------------------------
    if not main_rank:
        mesh.barrier(waits)
        logger.finish()
        return stats
    if os.path.exists(os.path.join(ckpt.save_dir, BEST)):
        model.load_state_dict(ckpt.restore_best(), strict=True)
    else:
        # No epoch ever improved the criterion (e.g. num_epochs <
        # start_val_epoch): evaluate the final state instead.
        print("warning: no best checkpoint; evaluating final state")

    t0 = time.time()
    stats["soccernet"] = {}
    for split in EVAL_SPLITS:
        split_path = os.path.join(args.data_root, cfg.dataset, f"{split}.json")
        if not os.path.exists(split_path):
            continue
        data = VideoWindows(
            cfg.dataset,
            split_path,
            cfg.frame_dir,
            cfg.clip_len,
            overlap_len=spec.eval_overlap_len(cfg.clip_len),
            stride=spec.eval_stride,
            labels_root=labels_root,
            decoder=decoder,
            cache=frame_cache,
        )
        maps, tols = evaluate(
            predict_fn,
            data,
            split.upper(),
            classes,
            save_pred=os.path.join(ckpt.save_dir, f"pred-{split}"),
            printed=True,
            test=True,
            augment=spec.hflip_tta,
            labels_root=labels_root,
        )
        if maps is not None:
            logger.log_test(split, maps, tols)
        preds_root = os.path.join(ckpt.save_dir, "preds")
        if cfg.dataset == "soccernet":
            stats["soccernet"][split] = soccernet.evaluate_sn_official(
                labels_root, preds_root, split)
        elif cfg.dataset == "soccernetball":
            stats["soccernet"][split] = soccernet.evaluate_snb(labels_root, preds_root, split)
    stats["test_s"] = time.time() - t0
    stats["frame_cache"] = frame_cache.stats() if frame_cache is not None else None
    logger.finish()
    if waits is not None:
        mesh.barrier(waits)
    print("CORRECTLY FINISHED TRAINING AND INFERENCE")
    return stats


if __name__ == "__main__":
    main()
