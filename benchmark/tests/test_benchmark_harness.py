"""The harness on the CPU: what it imports, what BENCHMARK.json may hold,
and that a cell, a configuration, a traffic kind and a per-layer metric
are added by new files and entries alone."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
BANNED = {"jax", "jaxlib", "flax", "tdeed_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _imports(path: Path):
    """Top-level names of every module a file imports (absolute imports)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("package", ["benchmark", "tdeed_tpu_torch"])
def test_no_module_imports_jax_or_the_jax_package(package):
    for path in (ROOT / package).rglob("*.py"):
        if "tests" in path.relative_to(ROOT).parts:
            continue
        found = set(_imports(path)) & BANNED
        assert not found, f"{path} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "tdeed_tpu_torch" not in set(_imports(path)), path


def test_top_level_names_are_compared_whole():
    sys.path.insert(0, str(ROOT))
    from benchmark import run

    before = dict(sys.modules)
    try:
        sys.modules["tdeed_tpu_torch_like"] = sys
        assert run.banned_modules() == []
        sys.modules["tdeed_tpu.models"] = sys
        assert run.banned_modules() == ["tdeed_tpu"]
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_names_and_units():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in b["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    assert len(json.dumps(b)) <= 64 * 1024


def test_every_cell_has_its_files():
    b = _bench()
    for w in b["workloads"]:
        assert (BENCH / "cells" / f"{w['name']}.json").is_file()
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "kinds" / f"{mix['kind']}.py").is_file()
    for m in b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()


def test_each_per_layer_metrics_cells_report_what_it_moves():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = [w["name"] for w in b["workloads"]]
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
    for cell in cells:  # every cell: setup_s, another end-to-end metric, a per-layer one
        assert sum(1 for m in b["end_to_end"] if cell in m.get("workloads", cells)) >= 2
        assert any(cell in m.get("workloads", cells) for m in b["per_layer"])


# A run in a copy of the benchmark, with a card faked: torch.cuda answers
# as one card would, and the kind below needs nothing else of it.
FAKE_CARD = """
import runpy, sys, torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
torch.cuda.synchronize = lambda *a, **k: None
torch.cuda.max_memory_allocated = lambda *a, **k: 1 << 20
torch.cuda.get_device_name = lambda *a, **k: "fake"
if len(sys.argv) > 1 and sys.argv[1] == "--load-jax-package":
    sys.argv.pop(1)
    sys.modules["tdeed_tpu"] = sys
sys.argv[0] = "benchmark.run"
runpy.run_module("benchmark.run", run_name="__main__")
"""

TINY_KIND = '''"""A kind that counts to n: the tests' stand-in for a new traffic kind."""


class Cell:
    def __init__(self, cfg_file, mix, seed, device="cuda"):
        self.n = mix["n"] + cfg_file["offset"] + seed % 2
        self.attempted = self.failed = 0
        self.readings = {}

    def window(self, seconds):
        self.attempted = self.n
        self.readings["count"] = self.n
        return {"counted_per_s": self.n / seconds}

    def traced(self):
        return {"busy_ms": 1.0, "wall_ms": 2.0, "ms_by_op": {"count": 1.0}, "gaps": []}

    def check(self):
        return {"count_gap": 0.0}
'''


def _copy(tmp_path: Path) -> Path:
    """A checkout holding the benchmark and the files it reads."""
    dst = tmp_path / "checkout"
    shutil.copytree(BENCH, dst / "benchmark", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    (dst / "fake_card.py").write_text(FAKE_CARD)
    return dst


def _extend(dst: Path) -> None:
    """A new configuration, traffic mix and kind, cell and per-layer
    metric: new files, and new entries in BENCHMARK.json."""
    bdir = dst / "benchmark"
    (bdir / "configs" / "Tiny.json").write_text(json.dumps({"offset": 2}))
    (bdir / "traffic" / "count.json").write_text(json.dumps({"kind": "tiny_count", "n": 5}))
    (bdir / "kinds" / "tiny_count.py").write_text(TINY_KIND)
    (bdir / "cells" / "Tiny.count.json").write_text(json.dumps({"limits": {"count_gap": 0.0}}))
    (bdir / "metrics" / "tiny.count_twice.py").write_text(
        '"""Twice the count."""\n\n\ndef read(r):\n    return 2.0 * r["count"]\n')
    b = json.loads((dst / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "Tiny", "source": "https://example.org/tiny", "file":
                         "benchmark/configs/Tiny.json", "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "Tiny.count", "config": "Tiny", "traffic": "count",
                           "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "counted_per_s", "unit": "1/s", "better": "higher",
                            "bound": 0.01, "source": "host_clock", "workloads": ["Tiny.count"]})
    b["per_layer"].append({"name": "tiny.count_twice", "unit": "1", "better": "higher",
                           "source": "program_counter", "layer": "tiny", "moves": "counted_per_s",
                           "workloads": ["Tiny.count"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(b))


def _run(dst: Path, *args):
    env = dict(os.environ, PYTHONPATH=str(dst))
    return subprocess.run([sys.executable, *args], cwd=dst, env=env, capture_output=True,
                          text=True, timeout=300)


def test_a_cell_config_kind_and_metric_are_added_by_files_and_entries(tmp_path):
    dst = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (dst / "benchmark").rglob("*") if p.is_file()}
    _extend(dst)
    for p, data in before.items():  # no file the benchmark had was edited
        assert p.read_bytes() == data, p
    base = ["fake_card.py", "--workload", "Tiny.count", "--seed", "3", "--seconds", "2"]
    r = _run(dst, *base, "--trace", "0")
    assert r.returncode == 0, r.stderr
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] == 8
    assert line["metrics"]["counted_per_s"]["value"] == 4.0
    assert set(line["metrics"]) == {"counted_per_s", "setup_s"}
    assert list(line)[-1] == "compared" and line["compared"]["count_gap"]["limit"] == 0.0
    r = _run(dst, *base, "--trace", "1")
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["metrics"] == {"tiny.count_twice": {"value": 16.0, "unit": "1"}}
    assert line["device"]["busy_s"] == 0.001 and line["device"]["window_s"] == 0.002


def test_a_run_that_loaded_the_jax_package_prints_no_result(tmp_path):
    dst = _copy(tmp_path)
    _extend(dst)
    r = _run(dst, "fake_card.py", "--load-jax-package", "--workload", "Tiny.count", "--seed", "3",
             "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and not r.stdout.strip()
    assert "tdeed_tpu" in r.stderr


def test_a_run_without_a_card_exits_non_zero_and_prints_no_result():
    r = _run(ROOT, "-m", "benchmark.run", "--workload", "FineDiving_small.train_step",
             "--seed", "2147483801", "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and not r.stdout.strip()


def test_a_checkout_of_only_the_benchmark_exits_non_zero(tmp_path):
    dst = _copy(tmp_path)
    r = _run(dst, "fake_card.py", "--workload", "FineDiving_small.train_step", "--seed", "5",
             "--seconds", "1", "--trace", "0")
    assert r.returncode != 0 and not r.stdout.strip()
