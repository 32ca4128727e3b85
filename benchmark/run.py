"""Run one cell of the benchmark and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Everything the run needs is found by name:
the cell, its configuration and its traffic mix in ``BENCHMARK.json``;
the configuration's file; ``benchmark/traffic/<mix>.json`` (the mix's
parameters and its ``kind``); ``benchmark/kinds/<kind>.py`` (the
generator, the driver of the program and the check); the limits of the
check in ``benchmark/cells/<cell>.json``; and each per-layer metric's
reader in ``benchmark/metrics/<metric>.py``.

A run: set-up (the weights and inputs from the seed, the program built
and driven through the check's first steps and the warm-up); then the
window of ``--seconds``; with ``--trace 1`` a traced stretch after it;
then, with the program's state freed, the reference and the comparison.
With ``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones. Without enough cards, or if JAX or the
JAX package was loaded, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED = ("jax", "jaxlib", "flax", "tdeed_tpu")


def _find(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"benchmark: no {what} named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(name: str):
    """The ``read(readings)`` function of a per-layer metric's module."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def banned_modules() -> list:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def plan(workload: str):
    """(cell, configuration file's keys, traffic mix, limits, end-to-end
    metrics, per-layer metrics) of a cell, all by name."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = _find(bench["workloads"], workload, "workload")
    config = _find(bench["configs"], cell["config"], "configuration")
    cfg_file = json.loads((ROOT / config["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "cells" / f"{workload}.json").read_text())["limits"]
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return cell, cfg_file, mix, limits, e2e, per_layer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell, cfg_file, mix, limits, e2e, per_layer = plan(args.workload)

    # build and kernel caches at fixed paths inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count is {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from benchmark.compare import judge
    from benchmark.trace import breakdown

    kind = importlib.import_module(f"benchmark.kinds.{mix['kind']}")
    run = kind.Cell(cfg_file, mix, args.seed)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - T0

    measured = run.window(args.seconds)
    peak = torch.cuda.max_memory_allocated()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": peak, "power_limit": power_limit()}
    out = {}
    if args.trace:
        trace = run.traced()
        device.update(busy_s=trace["busy_ms"] / 1e3, window_s=trace["wall_ms"] / 1e3)
        metrics = {}
        for m in per_layer:
            value = load_reader(m["name"])(run.readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["breakdown"] = breakdown(trace)
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in e2e:
            if m["name"] != "setup_s":
                metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}

    numbers = run.check()
    correct = judge(numbers, limits) and run.failed == 0
    found = banned_modules()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    compared = {n: {"value": numbers.get(n), "limit": lim} for n, lim in limits.items()}
    for n, c in compared.items():
        print(f"{n} {c['value']} limit {c['limit']}", file=sys.stderr)
    # the check's other numbers, held to no limit, then those compared
    readings = {n: v for n, v in numbers.items() if n not in limits}
    line = {"correct": correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device, **out,
            "readings": readings, "compared": compared}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
