"""SoccerNet Ball challenge-geometry benchmark: training and predict at
796x448 full frames (port of tools/bench_snb.py).

    python -m tdeed_tpu_torch.tools.bench_snb [--variants k1,plain,remat] \\
        [--acc 1|2] [--steps 10] [--warmup 3] [--device cuda|cpu]

The envelope is SoccerNetBall_challenge1's (configs/SoccerNetBall/
SoccerNetBall_challenge1.json; frames ref: extract_frames_snb.py:22-23):
batch 4 x clip 100 of full 448x796 frames (no crop), rny002_gsf, 2
SGP-Mixer layers, kernel 9, r 4, displacement radius 4, mixup, and the
joint-pretraining double head (12 + 17 classes, every clip SoccerNet
Ball's). Batches are the JAX tool's: numpy's default_rng(0) drawn in its
order (``measure.make_batch``), two distinct batches put on the card before
timing and cycled.

The JAX tool's variants (matmul, cond, xla, ungated) choose how the TPU
schedules the hflip and the gating of its Pallas kernel; the port's K1
has one design, so its variants are the knobs the port has:

  k1      the default step, K1 (csrc/photometric.cu) once a micro-batch;
  plain   ``pallas_augment=False``: the plain photometric chain, K1 never
          launched;
  remat   ``checkpoint_backbone``.

``--acc`` sets acc_grad_iter (micro-batches of batch/acc clips). For each
variant: the step's ms (median, min, max, n; each step on the host clock,
ending in a synchronize), frames/s at the median, the peak device memory,
K1's launches a step and the last loss; then predict at the same geometry
(batch ``--batch``, plain). A variant that does not fit the card fails the
run, naming itself: nothing falls back to remat. Prints one JSON line.

``--device cpu`` runs the plain versions in fp32 on the host at the sizes
given (the JAX tool's smoke sizes work: ``--height 32 --width 64 --batch 2
--clip-len 4 --steps 2``); its JSON says "platform": "cpu" and holds no
device memory.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from tdeed_tpu_torch.tools.measure import (
    BATCH,
    CLIP_LEN,
    HEIGHT,
    NUM_BATCHES,
    NUM_CLASSES,
    RADI_DISPLACEMENT,
    TWO_HEADS,
    WIDTH,
    make_batch,
    on_device,
    predict_calls,
    snb_config,
    train_steps,
)
from tdeed_tpu_torch.utils.profiling import peak_gib, platform, reset_peak

# variant -> (TDEEDConfig overrides, pallas_augment)
VARIANTS = {
    "k1": ({}, None),
    "plain": ({}, False),
    "remat": ({"checkpoint_backbone": True}, None),
}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--variants", default="k1,plain,remat")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--clip-len", type=int, default=CLIP_LEN)
    p.add_argument("--height", type=int, default=HEIGHT)
    p.add_argument("--width", type=int, default=WIDTH)
    p.add_argument("--acc", type=int, default=1, help="acc_grad_iter (micro-batch = batch/acc)")
    p.add_argument("--device", default="cuda", help="where the model runs (default: the card)")
    args = p.parse_args(argv)
    names = args.variants.split(",")
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        p.error(f"unknown variants {unknown}; choose from {sorted(VARIANTS)}")
    where = platform("bench_snb", args.device)

    from tdeed_tpu_torch.models.tdeed import build_model

    b, t, h, w, dev = args.batch, args.clip_len, args.height, args.width, args.device
    r = np.random.default_rng(0)
    batches = [on_device(make_batch(r, b, t, h, w, NUM_CLASSES + 1, RADI_DISPLACEMENT, True),
                         dev) for _ in range(NUM_BATCHES)]
    torch.manual_seed(0)
    init = build_model(snb_config(t, dev), TWO_HEADS, device="cpu").state_dict()

    results: dict = {"tool": "bench_snb", **where, "geometry": f"{w}x{h}", "batch": b,
                     "clip_len": t, "acc_grad_iter": args.acc}
    for name in names:
        overrides, pallas_augment = VARIANTS[name]
        try:
            results[name] = train_steps(snb_config(t, dev, **overrides), init, batches,
                                        acc=args.acc, warmup=args.warmup, steps=args.steps,
                                        device=dev, pallas_augment=pallas_augment)
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError(f"bench_snb: variant {name!r} at batch {b}, acc_grad_iter "
                               f"{args.acc} does not fit the card") from e
        print(f"[{name}] {results[name]['step_ms']['median']:.2f} ms/step "
              f"({results[name]['frames_per_sec']:.1f} frames/s)", flush=True)
        reset_peak(dev)  # frees the variant's cached blocks

    # predict at the SNB geometry (eval protocol batch, plain pass)
    del batches
    model = build_model(snb_config(t, dev), TWO_HEADS, device=dev)
    model.load_state_dict(init)
    frames = [torch.from_numpy(r.integers(0, 253, (b, t, h, w, 3), np.uint8)).to(dev)
              for _ in range(NUM_BATCHES)]
    reset_peak(dev)
    results["predict"] = predict_calls(model, None, RADI_DISPLACEMENT, frames,
                                       calls=max(args.steps, 5), device=dev)[False]
    results["predict"]["peak_gib"] = peak_gib(dev)
    print(f"[predict] {results['predict']['frames_per_sec']:.1f} frames/s", flush=True)

    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
