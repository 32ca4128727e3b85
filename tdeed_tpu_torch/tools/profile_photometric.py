"""Profile of the photometric kernel K1 and of the training step around it.

    python -m tdeed_tpu_torch.tools.profile_photometric [--device cuda|cpu] [--no-train]

1. K1 (kernels/augment.py:photometric) on (8, 100, 224, 224, 3) bf16, the
   flagship mixup blend, under these parameter sets: ``sampled``
   (``sample_params`` seeded with 1, the set chip_smoke.py times),
   ``all_gates`` (every gate on in every clip), ``none`` (every gate off)
   and each gate alone on in every clip. For each: the time of one call
   from CUDA events over ITERS calls; for the first two also the device
   kernels of one call from a ``torch.profiler`` trace of TRACE_ITERS
   calls.
2. One flagship training step (FineDiving_small: batch 8 x clip 100, 256^2
   uint8 cropped to 224, mixup on, bf16), traced after WARM_STEPS steps:
   the device time of the whole step, of the ops under the step's
   ``mixup`` annotation (the fp32 blend and its bf16 cast) and of K1's
   kernel, and the top device ops.

Traces go under build/photometric_trace/. ``--device cpu`` runs the same
code on the plain versions at a small size (K1 on (2, 3, 20, 30, 3), the
step at batch 2, 72^2 frames cropped to 64, fp32) and measures no device.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import DeviceType

from tdeed_tpu_torch.kernels.augment import photometric, sample_params
from tdeed_tpu_torch.utils.profiling import time_fn, trace

CONFIGS = str(Path(__file__).resolve().parents[2] / "configs")
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "photometric_trace"
ITERS = 20
TRACE_ITERS = 5
WARM_STEPS = 2
GATES = {"hue": 0, "sat": 2, "bri": 4, "con": 6, "blur": 8, "flip": 14}  # param slots
# (K1 shape (B, T, H, W), train frame side, train crop, compute dtype)
SIZES = {
    "cuda": ((8, 100, 224, 224), 256, 224, None),
    "cpu": ((2, 3, 20, 30), 72, 64, "float32"),
}


def k1_params(batch: int, device) -> Dict[str, torch.Tensor]:
    """The parameter sets: sampled (seed 1), every gate on, every gate off,
    and each gate alone, the factors those of the sampled set."""
    sampled = sample_params(torch.Generator().manual_seed(1), batch)

    def gates(*on):
        p = sampled.clone()
        p[:, list(GATES.values())] = 0.0
        p[:, [GATES[g] for g in on]] = 1.0
        return p.to(device)

    return {"sampled": sampled.to(device), "all_gates": gates(*GATES), "none": gates(),
            **{g: gates(g) for g in GATES}}


def k1_frames(shape: Sequence[int], device) -> torch.Tensor:
    """A bf16 blend of values 0..255, seeded."""
    g = torch.Generator(device=device).manual_seed(0)
    return (torch.rand(*shape, 3, generator=g, device=device) * 255).to(torch.bfloat16)


def device_ops(prof, calls: int) -> List[Tuple[str, float, int]]:
    """Device ops of a trace: (name, ms per call of the traced region,
    launches), the most time first."""
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    return [(e.key, e.self_device_time_total / 1e3 / calls, e.count) for e in ops]


def region_ms(prof, name: str) -> float:
    """Device ms of the ops launched under the CPU annotations ``name``."""
    return sum(e.device_time_total for e in prof.events()
               if e.name == name and e.device_type == DeviceType.CPU) / 1e3


def profile_k1(shape, device) -> Dict[str, dict]:
    frames = k1_frames(shape, device)
    on_card = torch.device(device).type == "cuda"
    out = {}
    for name, params in k1_params(shape[0], device).items():
        ms = time_fn(photometric, frames, params, device=device, warmup=2, iters=ITERS) * 1e3
        kernels = []
        if on_card and name in ("sampled", "all_gates"):
            with trace(str(TRACE_DIR / f"k1_{name}"), device) as prof:
                for _ in range(TRACE_ITERS):
                    photometric(frames, params)
                torch.cuda.synchronize()
            kernels = device_ops(prof, TRACE_ITERS)
        out[name] = {"ms": ms, "kernels": kernels}
        print(f"[k1] {name} {tuple(frames.shape)} bf16: {ms:.4f} ms per call "
              f"({'CUDA events' if on_card else 'host clock, plain version'})", flush=True)
        for op, op_ms, n in kernels:
            print(f"[k1]   {name}: {op_ms:.4f} ms per call, {n} launches in "
                  f"{TRACE_ITERS} calls  {op[:100]}", flush=True)
    return out


def profile_train_step(frame: int, crop: int, dtype: Optional[str], device) -> dict:
    from tdeed_tpu_torch import load_config
    from tdeed_tpu_torch.models.tdeed import build_model
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_train_step

    overrides = {"dtype": dtype} if dtype else {}
    cfg = load_config("FineDiving_small", config_root=CONFIGS, **overrides)
    b = cfg.batch_size if torch.device(device).type == "cuda" else 2
    torch.manual_seed(0)
    model = build_model(cfg, device=device)
    opt, sched = make_optimizer(model.parameters(), cfg.learning_rate, 100, 10_000)
    step = make_train_step(model, opt, sched, crop_dim=crop,
                           num_classes_bg=cfg.num_classes_bg, mixup=cfg.mixup,
                           radi_displacement=cfg.radi_displacement, seed=0)
    g = torch.Generator(device=device).manual_seed(3)

    def ints(lo, hi, shape, dt=torch.int64):
        return torch.randint(lo, hi, shape, generator=g, device=device, dtype=dt)

    t = cfg.clip_len
    batch = {"frame": ints(0, 256, (b, t, frame, frame, 3), torch.uint8),
             "frame2": ints(0, 256, (b, t, frame, frame, 3), torch.uint8),
             "label": ints(0, cfg.num_classes_bg, (b, t)),
             "label2": ints(0, cfg.num_classes_bg, (b, t)),
             "labelD": ints(-2, 3, (b, t)).float(), "labelD2": ints(-2, 3, (b, t)).float()}
    for _ in range(WARM_STEPS):
        float(step(batch)["loss"])
    on_card = torch.device(device).type == "cuda"
    with trace(str(TRACE_DIR / "train_step"), device) as prof:
        float(step(batch)["loss"])
        if on_card:
            torch.cuda.synchronize()
    ops = device_ops(prof, 1) if on_card else []
    res = {"step_device_ms": sum(ms for _, ms, _ in ops),
           "mixup_ms": region_ms(prof, "mixup"),
           "photometric_ms": sum(ms for op, ms, _ in ops if "photometric" in op),
           "top": ops[:8]}
    what = "device" if on_card else "no device on the cpu: 0"
    print(f"[train] batch {b} x clip {t}, {frame}^2 uint8 -> crop {crop}, mixup "
          f"{cfg.mixup}, {cfg.dtype}: {what} ms: step {res['step_device_ms']:.3f}, "
          f"mixup blend and bf16 cast {res['mixup_ms']:.3f}, photometric "
          f"{res['photometric_ms']:.3f}", flush=True)
    for op, ms, n in res["top"]:
        print(f"[train]   {ms:8.3f} ms, {n} launches  {op[:100]}", flush=True)
    return res


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--no-train", action="store_true", help="K1 only")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("profile_photometric: no CUDA device; pass --device cpu")
    shape, frame, crop, dtype = SIZES[args.device]
    if args.device == "cuda":
        print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    out = {"k1": profile_k1(shape, args.device)}
    if not args.no_train:
        out["train"] = profile_train_step(frame, crop, dtype, args.device)
    return out


if __name__ == "__main__":
    main()
