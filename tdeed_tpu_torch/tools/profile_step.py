"""Where a flagship training step's time goes, by component and from a
trace (port of tools/profile_step.py with tools/profile_trace.py and
tools/trace_attrib.py).

    python -m tdeed_tpu_torch.tools.profile_step [--iters 10] [--trace DIR] \\
        [--device cuda|cpu]

Components at the flagship envelope (FineDiving_small: rny002_gsf, batch
8 x clip 100, 256x256 uint8 frames cropped to 224, mixup, bf16), each
the median of ``--iters`` calls after a warm-up, on the host clock ending
in a synchronize, over two distinct inputs cycled:

  train step            crop, mixup, K1, forward, loss, backward, AdamW;
  predict step          center crop, eval forward, softmax, decode;
  K1 (train preprocess) kernels.augment.train_preprocess on the cropped
                        uint8 frames;
  trunk fwd (shift=None) / (shift=gsf)  RegNet-Y-002 in eval mode on the
                        (B*T, 3, 224, 224) bf16 frames;
  SGP U-Net fwd         the 2-layer SGP-Mixer on (8, 100, 368) bf16.

``--trace DIR`` also captures 3 steady train steps with ``torch.profiler``
(after a traced step it throws away; the Chrome trace in DIR/trace.json)
and reduces them with ``utils.profiling.device_breakdown``: device ms by
op (top 20) and by the step's regions (``ms_by_region``: draw, zero_grad,
crop, mixup, K1, trunk, temporal, heads, loss, backward with
backward.heads, backward.temporal and backward.trunk inside it,
optimizer), the device's busy ms, the kernel launches and those the trace
lost (``dropped``, which must be 0), and K1's kernel with its launches in
the window. Beside the device ms by region stands ``host_cpu_ms_by_region``:
the CPU ms the host thread of each region used over the same 3 steps
(the steps' records in ``utils.profiling.STEPS``; the backward segments'
on the autograd engine's thread), with ``host_cpu_ms_per_step``; a region
whose host CPU exceeds its device ms is one the host is slower to issue
than the card is to run, or one that waits for the card (CUDA spins at a
synchronous copy or a full launch queue, and the spin reads as CPU). The profiler's own host
work is in these steps' CPU too. The 3 steps' records are also written, on the
trace's clock, to DIR/spans.json: ``trace_start_ns`` (the Unix ns the
trace's times count from) and one entry a step (``utils.profiling
.record_json``: start and end in microseconds after it, host, main and
worker CPU ms, and each span's name, parent index, thread, start, end and
CPU ms). The profiler's own host work slows the traced steps, so the
idle share stands only untraced, ``idle_share_untraced``: 1 - the
device's busy ms a traced step over the untraced step's median. This is
the committed breakdown the records quote. Prints one JSON line.

``--device cpu`` runs the same at a tiny size (batch 2 x clip 8, 40x40
frames cropped to 32, fp32): host times of the plain versions, "platform":
"cpu" in the JSON.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tdeed_tpu_torch.tools import measure
from tdeed_tpu_torch.utils.profiling import (
    STEPS,
    device_breakdown,
    host_cpu_by_region,
    platform,
    record_json,
    trace,
)

TRACE_STEPS = 3
TOP_OPS = 20


def trace_train_steps(step, batches, logdir: Optional[str], device) -> Dict[str, object]:
    """``TRACE_STEPS`` steps of ``step`` (already warm) under the profiler,
    after one traced step thrown away (``trace``'s ``warmup``), each ending
    in a synchronize as the untimed steps do; reduced by
    ``device_breakdown``, with K1's kernel (the op whose name holds
    "photometric") and its launches in the window, and the traced steps'
    host CPU by region from their records (written to
    ``logdir``/spans.json when ``logdir`` is given)."""
    from tdeed_tpu_torch.kernels.augment import photometric

    on_card = torch.device(device).type == "cuda"
    with trace(logdir, device, warmup=1) as prof:
        for i in range(1 + TRACE_STEPS):
            if i == 1:
                launches = photometric.launches
            step(batches[i % len(batches)])
            if on_card:
                torch.cuda.synchronize(device)
            prof.step()
    records = [r for r in list(STEPS.records)[-TRACE_STEPS:] if r.profiled]
    if len(records) != TRACE_STEPS:
        raise RuntimeError(f"{len(records)} of the {TRACE_STEPS} traced steps left a "
                           "profiled record")
    out = {"steps": TRACE_STEPS,
           **device_breakdown(prof, device, top=TOP_OPS, always=("photometric",)),
           "host_cpu_ms_by_region": host_cpu_by_region(records),
           "host_cpu_ms_per_step": sum(r.host_cpu_ns for r in records) / 1e6 / TRACE_STEPS}
    if logdir is not None:
        t0 = prof.profiler.kineto_results.trace_start_ns()
        with open(os.path.join(logdir, "spans.json"), "w") as f:
            json.dump({"trace_start_ns": t0, "steps": [record_json(r, t0) for r in records]},
                      f)
    k1 = sorted(name for name in out["ms_by_op"] if "photometric" in name)
    out["k1_kernel"] = k1[0] if k1 else None
    out["k1_launches"] = photometric.launches - launches
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--trace", default=None, help="trace 3 train steps into this directory")
    p.add_argument("--device", default="cuda", help="where the model runs (default: the card)")
    args = p.parse_args(argv)
    dev = args.device
    where = platform("profile_step", dev)

    from tdeed_tpu_torch.kernels.augment import sample_params, train_preprocess
    from tdeed_tpu_torch.models.regnet import RegNetY
    from tdeed_tpu_torch.models.sgp import EDSGPMixer
    from tdeed_tpu_torch.models.tdeed import build_model
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_predict_step, make_train_step

    b, t, frame, crop, _ = measure.sizes(dev)["flagship"]
    cfg = measure.flagship_config(t, crop, dev)
    dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    r = np.random.default_rng(0)
    batches = [measure.on_device(measure.make_batch(
        r, b, t, frame, frame, cfg.num_classes_bg, cfg.radi_displacement, False), dev)
        for _ in range(measure.NUM_BATCHES)]
    cropped = [torch.from_numpy(r.integers(0, 256, (b, t, crop, crop, 3), np.uint8)).to(dev)
               for _ in range(measure.NUM_BATCHES)]
    torch.manual_seed(0)
    model = build_model(cfg, device=dev)
    opt, sched = make_optimizer(model.parameters(), 8e-4, 100, 10_000)
    step = make_train_step(model, opt, sched, crop_dim=crop, num_classes_bg=cfg.num_classes_bg,
                           mixup=True, radi_displacement=cfg.radi_displacement)
    frames_per_call = b * t
    components: Dict[str, dict] = {}

    def report(name, fn, inputs, warmup=1):
        ms = measure.time_calls(fn, inputs, warmup=warmup, calls=args.iters, device=dev)
        components[name] = {"ms": ms, "frames_per_sec": frames_per_call / ms["median"] * 1e3}
        print(f"{name:34s} {ms['median']:9.2f} ms   "
              f"{components[name]['frames_per_sec']:10.0f} frames/s", flush=True)

    report("train step", step, batches)
    traced = None
    if args.trace:
        traced = trace_train_steps(step, batches, args.trace, dev)
        # the profiler's host work slows the traced steps: the device's
        # busy time a step against the untraced step's median
        traced["busy_ms_per_step"] = traced["busy_ms"] / traced["steps"]
        traced["idle_share_untraced"] = 1 - (traced["busy_ms_per_step"]
                                             / components["train step"]["ms"]["median"])

    predict = make_predict_step(model, crop_dim=crop, radi_displacement=cfg.radi_displacement)
    report("predict step", lambda f: predict(f, False), [x["frame"] for x in batches])

    params = [sample_params(torch.Generator().manual_seed(i), b).to(dev) for i in range(2)]
    report("K1 (train preprocess)", lambda i: train_preprocess(cropped[i], params[i]), [0, 1])

    x = [c.reshape(b * t, crop, crop, 3).permute(0, 3, 1, 2).to(dtype) for c in cropped]
    with torch.no_grad():
        for shift in (None, "gsf"):
            trunk = RegNetY("rny002", clip_len=t, shift_mode=shift).to(dev).eval()
            report(f"trunk fwd (shift={shift})", trunk, x)
            del trunk
        feat = [torch.from_numpy(r.normal(size=(b, t, 368)).astype(np.float32)).to(dev)
                .to(dtype) for _ in range(2)]
        sgp = EDSGPMixer(368, t, num_layers=2, kernel_size=7, k=4).to(dev).eval()
        report("SGP U-Net fwd", sgp, feat)

    out = {"tool": "profile_step", **where, "batch": b, "clip_len": t, "crop": crop,
           "components": components}
    if traced is not None:
        out["trace"] = traced
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
