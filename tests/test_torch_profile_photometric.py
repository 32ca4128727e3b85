"""The photometric profile tool (tdeed_tpu_torch/tools/profile_photometric.py)
on the CPU: its parameter sets, and a whole run on the plain versions at
its small CPU size, which measures no device."""

import torch

from tdeed_tpu_torch.tools import profile_photometric as tool


def test_parameter_sets_turn_on_what_they_name():
    sets = tool.k1_params(8, "cpu")
    on = {name: (p[:, list(tool.GATES.values())] > 0.5) for name, p in sets.items()}
    assert bool(on["all_gates"].all()) and not bool(on["none"].any())
    for gate, slot in tool.GATES.items():
        col = list(tool.GATES.values()).index(slot)
        assert bool(on[gate][:, col].all())
        assert int(on[gate].sum()) == 8  # that gate alone, in every clip
    factors = [1, 3, 5, 7, 9, 10, 11, 12, 13]
    for p in sets.values():  # the sampled set's factors and taps throughout
        assert torch.equal(p[:, factors], sets["sampled"][:, factors])


def test_cpu_run_reports_every_set_and_no_device_time(monkeypatch, tmp_path):
    monkeypatch.setattr(tool, "TRACE_DIR", tmp_path / "trace")
    out = tool.main(["--device", "cpu"])
    assert not (tmp_path / "trace").exists()  # a CPU run writes no trace file
    assert set(out["k1"]) == {"sampled", "all_gates", "none", *tool.GATES}
    assert all(r["kernels"] == [] for r in out["k1"].values())  # no trace without a card
    assert out["train"]["step_device_ms"] == 0.0 and out["train"]["photometric_ms"] == 0.0
