"""Probe of three memory-access patterns on the card (port of
tools/profile_pallas_probe.py).

    python -m tdeed_tpu_torch.tools.profile_probe [--device cuda|cpu] [--shape H,W,C,N]

On x, (H, W, C, N) bf16 (default (112, 112, 24, 800), 482 MB, the batch N
minor), four variants, each a kernel of kernels/probe.py:
  stream    x * 1.03125, a pure pass-through: the memory rate;
  perpix    per pixel (C, C) @ (C, N) with fp32 sums: the conv1-dx pattern;
  stacked2  perpix on (H, W/2, 2C, N) with a (2C, 2C) weight;
  outerp    the pass-through plus the (C, C) fp32 sum of x x^T over the
            pixels: the conv1-dW pattern.
Inputs match the JAX tool's: x is numpy's default_rng(0).standard_normal
rounded to bf16 (stacked2 reads the same values in its shape), the (C, C)
weight default_rng(1) / sqrt(C), the (2C, 2C) one default_rng(2) / sqrt(2C).

Each variant is timed as a dependency chain x -> kernel -> x, 30
iterations after a warm-up, with CUDA events. It prints the time, the rate
of the bytes it must move, the time added over stream, its share of the
card's bound, the time of the one PyTorch call that computes the same
function, and the top device ops per iteration from a ``torch.profiler``
trace (written under build/probe_trace/). ``--device cpu`` runs the plain
PyTorch versions (use a small ``--shape``) and measures no device: no
bound share and no trace.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType

from tdeed_tpu_torch.kernels import probe
from tdeed_tpu_torch.utils.profiling import (
    PEAK_BF16_FLOPS,
    PEAK_BYTES_PER_S,
    PEAK_FP32_FLOPS,
    bound,
    card,
    time_fn,
    trace,
)

SHAPE = (112, 112, 24, 800)
ITERS = 30
TRACE_ITERS = 5
TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "probe_trace"


@dataclass
class Variant:
    name: str
    x: torch.Tensor
    kernel: Callable[[torch.Tensor], torch.Tensor]  # x -> an x-shaped output
    library: Callable[[torch.Tensor], torch.Tensor]
    library_what: str
    moved_bytes: int
    ops: int
    ops_per_s: float


@dataclass
class Result:
    name: str
    shape: Tuple[int, ...]
    ms: float
    gb_per_s: float
    bound_ms: float
    bound_by: str
    library_ms: float
    library_what: str
    top_ops: List[Tuple[str, float, int]]  # (op, ms per call, calls in TRACE_ITERS iterations)


def make_inputs(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (H, W, C, N) and the (C, C) and (2C, 2C) weights, bf16 on device."""
    c = shape[2]
    arrays = (
        np.random.default_rng(0).standard_normal(tuple(shape)),
        np.random.default_rng(1).standard_normal((c, c)) / np.sqrt(c),
        np.random.default_rng(2).standard_normal((2 * c, 2 * c)) / np.sqrt(2 * c),
    )
    return tuple(torch.from_numpy(a).to(device).to(torch.bfloat16) for a in arrays)


def variants(shape: Sequence[int], device) -> List[Variant]:
    h, w, c, n = shape
    x, w1, w2 = make_inputs(shape, device)
    stacked = x.view(-1)[: h * (w // 2) * 2 * c * n].view(h, w // 2, 2 * c, n)
    moved = 2 * x.numel() * 2  # bf16 read once, bf16 written once
    x32 = x.float()

    def perpix_variant(name, xv, wt):
        hh, ww, cc, nn = xv.shape
        return Variant(
            name, xv, lambda v: probe.perpix(v, wt), lambda v: torch.matmul(wt, v),
            "torch.matmul(wt, x)", 2 * xv.numel() * 2 + wt.numel() * 2,
            2 * hh * ww * cc * cc * nn, PEAK_BF16_FLOPS,
        )

    return [
        Variant("stream", x, probe.stream, lambda v: v * probe.SCALE, "x * 1.03125",
                moved, x.numel(), PEAK_FP32_FLOPS),
        perpix_variant("perpix", x, w1),
        perpix_variant("stacked2", stacked, w2),
        Variant(
            "outerp", x, lambda v: probe.outerp(v)[0],
            lambda v: torch.einsum("hwcn,hwdn->cd", x32, x32),
            "none computes both outputs; beside it einsum('hwcn,hwdn->cd') "
            "over an fp32 copy of x, the sum alone",
            moved + c * c * 4, 2 * h * w * c * c * n, PEAK_BF16_FLOPS,
        ),
    ]


def _time_chain(fn, x, device) -> float:
    """Seconds per call of the chain x -> fn -> x, ITERS calls after a
    warm-up call."""
    state = [fn(x)]

    def step():
        state[0] = fn(state[0])

    return time_fn(step, device=device, warmup=0, iters=ITERS)


def _top_device_ops(name, fn, x, device) -> List[Tuple[str, float, int]]:
    """The 4 device ops with the most time in a trace of TRACE_ITERS chained
    calls: (name, ms per call, calls). The per-call time stands even when
    the trace misses a launch, as the first trace of a process can."""
    x = fn(x)
    torch.cuda.synchronize()
    with trace(str(TRACE_DIR / name), device) as prof:
        for _ in range(TRACE_ITERS):
            x = fn(x)
        torch.cuda.synchronize()
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    return [(e.key, e.self_device_time_total / 1e3 / e.count, e.count) for e in ops[:4]]


def run(v: Variant, device) -> Result:
    on_card = torch.device(device).type == "cuda"
    sec = _time_chain(v.kernel, v.x, device)
    lib_sec = time_fn(v.library, v.x, device=device, warmup=2, iters=ITERS)
    bound_ms, bound_by = bound(v.moved_bytes, v.ops, v.ops_per_s)
    top = _top_device_ops(v.name, v.kernel, v.x, device) if on_card else []
    return Result(v.name, tuple(v.x.shape), sec * 1e3, v.moved_bytes / sec / 1e9,
                  bound_ms, bound_by, lib_sec * 1e3, v.library_what, top)


def _device_line(device) -> str:
    if torch.device(device).type != "cuda":
        return "device: cpu (the plain PyTorch versions; no device time is measured)"
    return f"device: {torch.cuda.get_device_name(device)}; nvidia-smi: {card()['smi']}"


def _report(r: Result, base: Optional[Result], on_card: bool) -> None:
    share = f"{r.bound_ms / r.ms:.0%} of it" if on_card else "share not measured on the cpu"
    print(f"{r.name:10s} {r.ms:8.3f} ms {r.gb_per_s:8.0f} GB/s   bound {r.bound_ms:.4g} ms "
          f"({r.bound_by}), {share}   library {r.library_ms:.3f} ms: {r.library_what}",
          flush=True)
    if base is not None:
        print(f"  {r.name} matmul delta: {r.ms - base.ms:+.3f} ms", flush=True)
    for op, ms, calls in r.top_ops:
        print(f"  [{r.name}] {ms:8.3f} ms/call, {calls} calls in {TRACE_ITERS} iterations  "
              f"{op[:80]}", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> List[Result]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--shape", default=",".join(map(str, SHAPE)),
                        help="H,W,C,N of x (C <= 32, so that stacked2's 2C <= 64)")
    args = parser.parse_args(argv)
    shape = tuple(int(s) for s in args.shape.split(","))
    if len(shape) != 4 or min(shape) < 1 or shape[1] < 2 or 2 * shape[2] > probe.MAX_C:
        parser.error(f"--shape must be H,W,C,N with W >= 2 and C <= {probe.MAX_C // 2}")
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("profile_probe: no CUDA device; pass --device cpu for the plain versions")

    print(_device_line(args.device), flush=True)
    print(f"x {shape} bf16; {ITERS} chained calls after a warm-up; bound from the "
          f"published H100 SXM peaks ({PEAK_BYTES_PER_S / 1e12} TB/s, "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16, {PEAK_FP32_FLOPS / 1e12:.0f} fp32)",
          flush=True)
    results: List[Result] = []
    for v in variants(shape, args.device):
        r = run(v, args.device)
        _report(r, results[0] if results else None, on_card)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
