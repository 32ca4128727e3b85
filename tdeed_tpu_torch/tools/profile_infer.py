"""Predict throughput, serving batch scaling and window aggregation on the
card (port of tools/profile_infer.py and tools/probe_serving_scale.py).

    python -m tdeed_tpu_torch.tools.profile_infer [--iters 20] [--snb] \\
        [--batches 2,4,8,16] [--agg] [--device cuda|cpu]

1. Flagship predict (FineDiving_small, rny002_gsf, eval batch 4 of 256x256
   uint8 frames center-cropped to 224, bf16): ``--iters`` calls after 5
   warm-up calls (measure.predict_calls), each on the host clock ending in
   a synchronize, over two distinct frame batches on the card.
2. ``--snb``: the SoccerNet Ball challenge geometry (448x796 full frames,
   no crop, clip 100, rny002_gsf with the 12 + 17 class double head, as
   tools/probe_serving_scale.py builds it) at each batch of ``--batches``.
3. ``--agg``: a SoccerNet half served through ``SpottingPredictor``
   (t_len 5,625, hop 50, 113 windows of 100 frames, batch 4; 8 distinct
   256x256 window batches cycled), its scores added on the card
   (``_spot_device``, one read at the end) and on the host
   (``infer.evaluate.predict_windows``, a read per batch): each path's
   seconds and frames/s; the two must give the same bits, or the run fails.

Peak device memory per part. Prints one JSON line. ``--device cpu`` runs
it on the host at a tiny size (fp32; the flagship at batch 2 x clip 8,
40x40 frames cropped to 32; SNB at 32x64, clip 4; a 40-frame video in
windows of 8), "platform": "cpu" in the JSON.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from tdeed_tpu_torch.tools import measure
from tdeed_tpu_torch.utils.profiling import peak_gib, platform, reset_peak

# SoccerNet half at stride 12 (45 min): t_len, hop, batch, distinct batches
AGG = {"cuda": (5625, 50, 4, 8), "cpu": (40, 4, 2, 2)}


def bench_predict(cfg, two_heads, b: int, h: int, w: int, iters: int, device,
                  r: np.random.Generator) -> Dict[str, object]:
    """Predict-step ms and frames/s of ``cfg``'s model (seeded random
    weights) on (b, clip, h, w, 3) uint8 frames on the device."""
    from tdeed_tpu_torch.models.tdeed import build_model

    torch.manual_seed(0)
    model = build_model(cfg, two_heads, device=device)
    frames = [torch.from_numpy(r.integers(0, 253, (b, cfg.clip_len, h, w, 3), np.uint8))
              .to(device) for _ in range(measure.NUM_BATCHES)]
    reset_peak(device)
    out = measure.predict_calls(model, cfg.crop_dim, cfg.radi_displacement, frames,
                                calls=iters, device=device)[False]
    out["peak_gib"] = peak_gib(device)
    return out


def bench_aggregation(device, r: np.random.Generator) -> Dict[str, object]:
    """A SoccerNet-length video's windows through the predictor, scores
    added on the device and on the host; both must give the same bits."""
    from tdeed_tpu_torch.config import TDEEDConfig
    from tdeed_tpu_torch.infer.evaluate import predict_windows
    from tdeed_tpu_torch.infer.predictor import SpottingPredictor
    from tdeed_tpu_torch.models.tdeed import build_model

    kind = torch.device(device).type
    _, clip_len, frame, crop, _ = measure.sizes(device)["flagship"]
    t_len, hop, bs, n_distinct = AGG[kind]
    cfg = TDEEDConfig(
        dataset="soccernet", num_classes=17, clip_len=clip_len, crop_dim=crop,
        feature_arch="rny002_gsf", n_layers=2, sgp_ks=7, sgp_r=4, radi_displacement=4,
        dtype="bfloat16" if kind == "cuda" else "float32",
    )
    torch.manual_seed(0)
    state = build_model(cfg, device="cpu").state_dict()
    classes = {f"c{i}": i for i in range(1, 18)}
    pred = SpottingPredictor(cfg, state, classes, batch_size=bs, device=device)
    starts = list(range(-5, t_len - clip_len // 2, hop))
    distinct = [r.integers(0, 256, (bs, clip_len, frame, frame, 3), np.uint8)
                for _ in range(n_distinct)]

    def batches():
        for ofs in range(0, len(starts), bs):
            fr = distinct[(ofs // bs) % len(distinct)]
            yield [{"video": "half1", "start": s, "frame": fr[i]}
                   for i, s in enumerate(starts[ofs:ofs + bs])]

    def host(batch_iter):
        pd = {"half1": (np.zeros((t_len, 18), np.float32), np.zeros(t_len, np.int32))}
        predict_windows(pred.predict_fn, pd, batch_iter, bs, False)
        return pd["half1"]

    warm = [next(iter(batches()))]  # both paths once before timing
    pred._spot_device(iter(warm), t_len, bs, False)
    host(iter(warm))
    reset_peak(device)
    t0 = time.perf_counter()
    scores_d, support_d = pred._spot_device(batches(), t_len, bs, False)
    dt_device = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores_h, support_h = host(batches())
    dt_host = time.perf_counter() - t0
    equal = bool(np.array_equal(scores_d, scores_h) and np.array_equal(support_d, support_h))
    if not equal:
        raise RuntimeError(
            f"profile_infer --agg: device and host aggregation differ: max |scores| diff "
            f"{float(np.abs(scores_d - scores_h).max())}, support equal "
            f"{bool(np.array_equal(support_d, support_h))}")
    n = len(starts) * clip_len
    return {"windows": len(starts), "t_len": t_len, "batch": bs,
            "device_agg_s": dt_device, "device_agg_frames_per_sec": n / dt_device,
            "host_agg_s": dt_host, "host_agg_frames_per_sec": n / dt_host,
            "equal_bits": equal, "peak_gib": peak_gib(device)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--snb", action="store_true")
    p.add_argument("--batches", default="2,4,8,16", help="--snb's batch sizes")
    p.add_argument("--agg", action="store_true")
    p.add_argument("--device", default="cuda", help="where the model runs (default: the card)")
    args = p.parse_args(argv)
    dev = args.device
    where = platform("profile_infer", dev)
    r = np.random.default_rng(0)

    b, t, frame, crop, pb = measure.sizes(dev)["flagship"]
    out = {"tool": "profile_infer", **where}
    out["predict"] = bench_predict(measure.flagship_config(t, crop, dev), None, pb, frame,
                                   frame, args.iters, dev, r)
    print(f"[predict] flagship b{pb}: {out['predict']['frames_per_sec']:.1f} frames/s",
          flush=True)
    if args.snb:
        _, st, sh, sw = measure.sizes(dev)["snb"]
        cfg = measure.snb_config(st, dev)
        out["snb"] = {"geometry": f"{sw}x{sh}", "clip_len": st}
        for sb in (int(x) for x in args.batches.split(",")):
            out["snb"][f"b{sb}"] = bench_predict(cfg, measure.TWO_HEADS, sb, sh, sw,
                                                 args.iters, dev, r)
            print(f"[snb] b{sb}: {out['snb'][f'b{sb}']['frames_per_sec']:.1f} frames/s",
                  flush=True)
    if args.agg:
        out["agg"] = bench_aggregation(dev, r)
        print(f"[agg] {out['agg']['windows']} windows: device {out['agg']['device_agg_s']:.2f} s, "
              f"host {out['agg']['host_agg_s']:.2f} s, equal bits", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
