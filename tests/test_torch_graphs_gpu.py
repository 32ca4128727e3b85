"""The model's layers replayed as CUDA graphs in training
(tdeed_tpu_torch/models/graphs.py) against the same steps run eagerly, on
the card. Needs a CUDA GPU; skips without one. The card's machine has no
JAX, and tests/conftest.py imports it, so run this file there without the
conftest:

    python -m pytest tests/test_torch_graphs_gpu.py -m gpu --noconftest -q

- From the same weights and draws, three graphed steps and three eager
  ones agree: each step's loss and every gradient, every parameter's
  change, every BatchNorm running statistic and batch count; at a tiny
  FineDiving-shaped config and a two-heads SoccerNet-Ball-shaped one, at
  ``acc_grad_iter`` 1 and 2. Two eager runs of the same steps may differ
  (cuDNN's algorithms): the graphed run is held to the eager one within a
  bf16 ulp of each tensor, or four times the two eager runs' own gap where
  that is wider, and both gaps are printed.
- A second input shape captures again and stays correct; past
  ``MAX_KEYS`` it runs eagerly and stays correct.
- The graphs' BatchNorm ticket counters read zero after the replays, and
  a dropped model frees its graphs without the garbage collector.
- The benchmark's ``device.graph_pool_gib.train`` reader, which sums the
  allocator's segments outside the default pool, grows by exactly the
  bytes of a new model's graph pool after its capture, replays leave it
  so, and reading it resets no peak statistic.
- A traced flagship step (FineDiving_small) puts the graphs' device time
  under ``trunk``, ``backward.trunk``, ``backward.temporal`` and
  ``backward.heads``, within 5% of the eager step's (the heads' backward,
  0.06 ms, within 0.02 ms), and holds no host wait.
"""

import statistics

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from tdeed_tpu_torch.models import graphs
from tdeed_tpu_torch.tools import measure
from tdeed_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

STEPS = 3
ULP = 2.0 ** -8  # bf16's relative spacing: 8 bits of mantissa
# name -> (model config, two heads, (batch, frame height, frame width))
CASES = {
    "finediving": (lambda: measure.flagship_config(16, 64, "cuda"), None, (4, 72, 96)),
    "snb": (lambda: measure.snb_config(16, "cuda"), measure.TWO_HEADS, (2, 64, 112)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _batches(case, n, seed=0, b=None):
    _, two_heads, (b0, h, w) = CASES[case]
    cfg = CASES[case][0]()
    r = np.random.default_rng(seed)
    return [measure.on_device(measure.make_batch(
        r, b or b0, cfg.clip_len, h, w, cfg.num_classes_bg, cfg.radi_displacement,
        two_heads is not None), "cuda") for _ in range(n)]


def _trainer(case, acc=1):
    from tdeed_tpu_torch.models.tdeed import build_model
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_train_step

    make_cfg, two_heads, _ = CASES[case]
    cfg = make_cfg()
    torch.manual_seed(0)
    model = build_model(cfg, two_heads, device="cuda")
    opt, sched = make_optimizer(model.parameters(), 8e-4, 1, 10_000)
    step = make_train_step(model, opt, sched, crop_dim=cfg.crop_dim,
                           num_classes_bg=cfg.num_classes_bg, mixup=True,
                           radi_displacement=cfg.radi_displacement, acc_grad_iter=acc)
    return model, step


def _run(case, batches, acc=1, eager=False):
    """Steps over ``batches`` from the seed's weights: per step (loss,
    gradients), then the parameters' changes and the buffers, and the
    layers replayed and run eagerly."""
    model, step = _trainer(case, acc)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    ring = profiling.StepRecorder()
    steps = []
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(profiling, "STEPS", ring)
        if eager:
            mp.setattr(graphs, "MAX_KEYS", 0)
        for batch in batches:
            loss = step(batch)["loss"]
            steps.append((float(loss), {n: p.grad.detach().clone()
                                        for n, p in model.named_parameters()}))
    finally:
        mp.undo()
    change = {n: p.detach() - p0[n] for n, p in model.named_parameters()}
    buffers = {n: b.detach().clone() for n, b in model.named_buffers()}
    counts = [(r.graph_layers, r.eager_layers) for r in ring.records]
    return steps, change, buffers, counts, model


def _gap(got, want):
    """The widest tensor's gap: |got - want| over the larger of |want| and
    the median tensor's norm (a tensor of one or two near-cancelling sums,
    such as a GSF gate's bias, is measured against the typical tensor)."""
    norms = {n: float(w.double().norm()) for n, w in want.items()}
    floor = statistics.median(norms.values())
    return max(float((got[n].double() - want[n].double()).norm()) / max(norms[n], floor, 1e-30)
               for n in want)


def _gaps(a, b):
    """Every gap between two runs of ``_run``: each step's loss and
    gradients, the changes, the running statistics and batch counts."""
    out = {}
    for i, ((la, ga), (lb, gb)) in enumerate(zip(a[0], b[0])):
        out[f"loss{i}"] = abs(la - lb) / max(abs(lb), 1e-30)
        out[f"grad{i}"] = _gap(ga, gb)
    out["change"] = _gap(a[1], b[1])
    stats = {n: t for n, t in b[2].items() if not n.endswith("num_batches_tracked")}
    out["running"] = _gap({n: a[2][n] for n in stats}, stats)
    out["batches"] = float(max((a[2][n] - b[2][n]).abs().max() for n in b[2]
                               if n.endswith("num_batches_tracked")))
    return out


def _assert_graphed_matches_eager(case, batches, acc, graphed_counts):
    eager = _run(case, batches, acc, eager=True)
    again = _run(case, batches, acc, eager=True)
    graphed = _run(case, batches, acc)
    assert all(c == (0, 3 * acc) for c in eager[3]), eager[3]
    assert graphed[3] == graphed_counts, graphed[3]
    noise, gaps = _gaps(again, eager), _gaps(graphed, eager)
    print(f"\n[graphs] {case} acc {acc} b {batches[0]['frame'].shape[0]}: graphed-eager "
          f"{gaps}\n  eager-eager {noise}")
    assert gaps["batches"] == 0
    for k, v in gaps.items():
        assert v <= max(ULP, 4 * noise[k]), (k, v, noise[k])
    return graphed


@pytest.mark.parametrize("acc", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_graphed_steps_match_eager_steps(cuda, case, acc):
    batches = _batches(case, STEPS)
    graphed = _assert_graphed_matches_eager(case, batches, acc, [(3 * acc, 0)] * STEPS)
    model = graphed[4]
    assert len(model._graphs.chains) == 1 and model._graphs.forwards.n == STEPS * acc


def test_a_second_shape_captures_again_and_stays_correct(cuda):
    batches = _batches("finediving", STEPS - 1) + _batches("finediving", 1, seed=1, b=2)
    graphed = _assert_graphed_matches_eager("finediving", batches, 1, [(3, 0)] * STEPS)
    assert len(graphed[4]._graphs.chains) == 2


def test_past_the_keys_a_new_shape_runs_eagerly_and_stays_correct(cuda, monkeypatch):
    monkeypatch.setattr(graphs, "MAX_KEYS", 1)
    batches = _batches("finediving", STEPS - 1) + _batches("finediving", 1, seed=1, b=2)
    graphed = _assert_graphed_matches_eager("finediving", batches, 1,
                                            [(3, 0)] * (STEPS - 1) + [(0, 3)])
    assert len(graphed[4]._graphs.chains) == 1


def test_graph_ticket_counters_read_zero_after_the_replays(cuda):
    from tdeed_tpu_torch.kernels import batchnorm

    model, step = _trainer("finediving")
    for batch in _batches("finediving", STEPS):
        step(batch)
    torch.cuda.synchronize()
    tickets = model._graphs._tickets
    assert tickets is not None and int(tickets.abs().sum()) == 0
    assert all(int(t.abs().sum()) == 0 for t in batchnorm._TICKETS.values())
    assert not batchnorm._CAPTURING


def _pool_segments(pool) -> int:
    """The allocator's bytes in ``pool``'s segments on the card, from its
    snapshot."""
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) == tuple(pool))


def test_the_pool_count_is_the_allocators_bytes_of_the_pool(cuda):
    """The reader grows by the bytes of the model's pool after its capture
    (the other private pools, earlier tests' graphs, stay as they were),
    replays and a second shape captured into the same pool keep it equal,
    and reading it resets no peak statistic."""
    import gc

    from benchmark.run import load_reader

    read = load_reader("device.graph_pool_gib.train")
    gc.collect()
    torch.cuda.empty_cache()  # releases the pools of graphs already dropped
    before = round(read({}) * 2**30)
    model, step = _trainer("snb")
    step(_batches("snb", 1)[0])
    torch.cuda.synchronize()
    g = model._graphs
    first = _pool_segments(g._pool)
    peak = torch.cuda.max_memory_reserved()
    assert first > 0 and round(read({}) * 2**30) == before + first
    for batch in _batches("snb", 2, seed=1):
        step(batch)  # replays allocate nothing in the pool
    assert _pool_segments(g._pool) == first and round(read({}) * 2**30) == before + first
    step(_batches("snb", 1, seed=2, b=1)[0])  # a new shape captures into the same pool
    assert len(g.chains) == 2
    assert round(read({}) * 2**30) == before + _pool_segments(g._pool) >= before + first
    assert torch.cuda.max_memory_reserved() >= peak


def test_a_dropped_model_frees_its_graphs_without_the_collector(cuda):
    """No reference cycle keeps the graphs and their memory pool alive
    once the model and its step are dropped."""
    import gc
    import weakref

    gc.disable()
    try:
        model, step = _trainer("finediving")
        step(_batches("finediving", 1)[0])
        (chain,) = model._graphs.chains.values()
        dropped = [weakref.ref(model._graphs), weakref.ref(chain.trunk)]
        del model, step, chain
        assert [r() for r in dropped] == [None, None]
    finally:
        gc.enable()


# --- the flagship step under the profiler ------------------------------------

TRACED = 3
REGIONS = ("trunk", "backward.trunk", "backward.temporal")


def _waits(name: str) -> bool:
    """A host wait of the CUDA runtime: a synchronise (a device scalar's
    read is a copy and a synchronise) or a synchronous copy. AdamW reads
    its step counts, CPU tensors, with ``aten::item``: no wait."""
    return "Synchronize" in name or name == "cudaMemcpy"


def _flagship(eager: bool):
    """Three flagship steps traced after two warm and one thrown away: (the
    breakdown, the events, the records)."""
    from tdeed_tpu_torch.models.tdeed import build_model
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_train_step

    b, t, frame, crop, _ = measure.sizes("cuda")["flagship"]
    cfg = measure.flagship_config(t, crop, "cuda")
    r = np.random.default_rng(0)
    batches = [measure.on_device(measure.make_batch(
        r, b, t, frame, frame, cfg.num_classes_bg, cfg.radi_displacement, False), "cuda")
        for _ in range(2)]
    torch.manual_seed(0)
    model = build_model(cfg, device="cuda")
    opt, sched = make_optimizer(model.parameters(), 8e-4, 100, 10_000)
    step = make_train_step(model, opt, sched, crop_dim=crop, num_classes_bg=cfg.num_classes_bg,
                           mixup=True, radi_displacement=cfg.radi_displacement)
    mp = pytest.MonkeyPatch()
    try:
        if eager:
            mp.setattr(graphs, "MAX_KEYS", 0)
        for i in range(2):
            step(batches[i])
        torch.cuda.synchronize()
        with profiling.trace(None, "cuda", warmup=1) as prof:
            for i in range(1 + TRACED):
                step(batches[i % 2])
                torch.cuda.synchronize()
                prof.step()
    finally:
        mp.undo()
    records = list(profiling.STEPS.records)[-TRACED:]
    events = [e for e in prof.events() if not e.is_async]
    out = profiling.device_breakdown(prof, "cuda")
    del model, step, opt, batches
    torch.cuda.empty_cache()
    return out, events, records


@pytest.fixture(scope="module")
def flagship():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return {"eager": _flagship(eager=True), "graphed": _flagship(eager=False)}


def test_traced_graphed_step_keeps_the_layers_device_time(flagship):
    eager, graphed = (flagship[k][0]["ms_by_region"] for k in ("eager", "graphed"))
    print(f"\n[graphs] traced ms by region, eager {eager}\n  graphed {graphed}")
    assert [(r.graph_layers, r.eager_layers) for r in flagship["graphed"][2]] == [(3, 0)] * TRACED
    for name in REGIONS:
        assert graphed[name] == pytest.approx(eager[name], rel=0.05), name
    assert graphed["backward.heads"] == pytest.approx(eager["backward.heads"], abs=0.02 * TRACED)


def test_traced_graphed_step_holds_no_host_wait(flagship):
    _, events, _ = flagship["graphed"]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    regions = [e for e in cpu if e.is_user_annotation]
    # each step: from its first region's start to its optimizer's end
    for opt in [e for e in regions if e.name == "optimizer"]:
        start = max(e.time_range.start for e in regions
                    if e.name == "crop" and e.time_range.start < opt.time_range.start)
        waits = [e.name for e in cpu if start <= e.time_range.start <= opt.time_range.end
                 and _waits(e.name)]
        assert not waits, waits
