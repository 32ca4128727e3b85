"""The rule that picks CUDA graphs or eager layers in training
(tdeed_tpu_torch/models/graphs.py), the step record's counts of them, the
benchmark's ``train_step.graph_share``, ``device.reserved_gib.train`` and
``device.graph_pool_gib.train`` readers, the gradients a replay hands
autograd, and the step's host draws
leaving for the card from pinned memory without a host wait, on the CPU.
The graphs themselves run on the card only: tests/test_torch_graphs_gpu.py.
"""

import copy

import pytest
import torch

from benchmark.run import load_reader
from tdeed_tpu_torch.kernels import augment, batchnorm
from tdeed_tpu_torch.models import graphs
from tdeed_tpu_torch.models.tdeed import build_model
from tdeed_tpu_torch.train import step as step_module
from tdeed_tpu_torch.utils import profiling
from test_torch_bench import _tiny_trainer, two_threads  # noqa: F401 (an autouse fixture)


def _model():
    from tdeed_tpu_torch.tools import measure

    torch.manual_seed(0)
    return build_model(measure.flagship_config(8, 32, "cpu"), device="cpu")


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture
def ring(monkeypatch):
    fresh = profiling.StepRecorder()
    monkeypatch.setattr(profiling, "STEPS", fresh)
    return fresh


# --- graph or eager ------------------------------------------------------------


def test_training_on_the_card_replays_graphs(model):
    model.train()
    assert graphs.eager_reason(model, "cuda") is None


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_the_cpu_runs_eagerly(model, device):
    model.train()
    assert graphs.eager_reason(model, device) == "not on the card"


def test_eval_mode_and_no_grad_run_eagerly(model):
    model.eval()
    try:
        assert graphs.eager_reason(model, "cuda") == "eval mode or grad off"
    finally:
        model.train()
    with torch.no_grad():
        assert graphs.eager_reason(model, "cuda") == "eval mode or grad off"
    with torch.inference_mode():
        assert graphs.eager_reason(model, "cuda") == "eval mode or grad off"


def test_a_process_group_runs_eagerly(model, monkeypatch):
    model.train()
    monkeypatch.setattr(graphs.mesh, "group_of", lambda m: object())
    assert graphs.eager_reason(model, "cuda") == "a process group"


@pytest.mark.parametrize("knob", ["checkpoint_backbone", "fuse_entry", "fuse_shift"])
def test_the_knobs_run_eagerly(knob):
    """checkpoint_backbone runs the layers eagerly in training; the
    fused-block knobs, which only the JAX package reads, leave them free to
    replay."""
    from tdeed_tpu_torch.tools import measure

    cfg = measure.flagship_config(8, 32, "cpu")
    setattr(cfg, knob, True)
    knobbed = build_model(cfg, device="cpu").train()
    want = "checkpoint_backbone" if knob == "checkpoint_backbone" else None
    assert graphs.eager_reason(knobbed, "cuda") == want


@pytest.fixture
def capturing(monkeypatch):
    """Graphs as if on the card: every forward may replay, and a capture
    records its key in place of capturing."""
    captured = []
    monkeypatch.setattr(graphs, "eager_reason", lambda *a, **k: None)

    def capture(self, model, frames, masks):
        captured.append((tuple(frames.shape), len([m for m in masks if m is not None])))
        return captured[-1]

    monkeypatch.setattr(graphs.ModelGraphs, "_capture", capture)
    return captured


def test_frames_that_need_grad_or_a_frozen_parameter_run_eagerly(model, capturing):
    model.train()
    g = graphs.ModelGraphs()
    assert g.chain(model, torch.empty(1, 8, 32, 32, 3, requires_grad=True), []) is None
    p = next(model.parameters())
    p.requires_grad_(False)
    try:
        assert g.chain(model, torch.empty(1, 8, 32, 32, 3), []) is None
    finally:
        p.requires_grad_(True)
    assert capturing == [] and g.chains == {}


def test_a_captured_key_replays_without_walking_the_model(model, capturing, monkeypatch):
    """After its capture a key costs the host no walk of the model's
    parameters or buffers: the storage check reads the captured list."""
    model.train()
    g = graphs.ModelGraphs()
    frames = torch.empty(1, 8, 32, 32, 3)
    first = g.chain(model, frames, [])

    def walk(*a, **k):
        raise AssertionError("walked the model")

    monkeypatch.setattr(model, "parameters", walk)
    monkeypatch.setattr(model, "buffers", walk)
    assert g.chain(model, frames, []) is first
    assert g.frames_buffer(model, frames.shape, frames.dtype, "cpu") is not None


def test_each_new_input_captures_up_to_the_limit_then_runs_eagerly(model, capturing):
    g = graphs.ModelGraphs()
    masks = [torch.ones(1, dtype=torch.bool)] * 2
    shapes = [(b, 8, 32, 32, 3) for b in range(1, graphs.MAX_KEYS + 2)]
    chains = [g.chain(model, torch.empty(s), masks) for s in shapes]
    assert chains[:-1] == capturing == [(s, 2) for s in shapes[:-1]]
    assert chains[-1] is None  # past MAX_KEYS: eager
    # a key seen before replays what it captured; the masks are part of the key
    assert g.chain(model, torch.empty(shapes[0]), masks) is chains[0]
    assert g.chain(model, torch.empty(shapes[0]), masks[:1] + [None]) is None
    # the trunk's input is handed out for captured shapes only
    assert g.frames_buffer(model, shapes[0], torch.float32, "cpu").shape == shapes[0]
    assert g.frames_buffer(model, shapes[0], torch.bfloat16, "cpu") is None
    assert g.frames_buffer(model, shapes[-1], torch.float32, "cpu") is None


def test_new_storage_drops_the_graphs(capturing):
    m = _model().train()
    g = graphs.ModelGraphs()
    frames = torch.empty(1, 8, 32, 32, 3)
    g.chain(m, frames, [])
    m._temp_fine.to(torch.float64)  # new storage for the temporal layer's parameters
    g.chain(m, frames, [])
    assert len(capturing) == 2 and len(g.chains) == 1
    with torch.no_grad():
        next(m.parameters()).add_(1.0)  # an in-place update keeps the graphs
    g.chain(m, frames, [])
    assert len(capturing) == 2


def test_a_copy_of_the_model_starts_with_no_graphs(model, capturing):
    model.train()
    model._graphs.chain(model, torch.empty(1, 8, 32, 32, 3), [])
    assert len(model._graphs.chains) == 1
    try:
        assert copy.deepcopy(model)._graphs.chains == {}
    finally:
        model._graphs = graphs.ModelGraphs()


def test_captured_kernels_take_the_graphs_ticket_counters():
    tickets = torch.zeros(batchnorm.TICKETS, dtype=torch.int32)
    with batchnorm.captured_tickets(tickets, 1234):
        assert batchnorm._tickets(torch.device("cpu"), 1234) is tickets
    assert not batchnorm._CAPTURING


# --- the gradients a replay hands autograd -------------------------------------


def _layer(w, x_static, flat):
    """A stand-in for a captured ``_Layer`` on the CPU: y = w * x, its
    "graphs" Python calls on the static tensors."""
    from types import SimpleNamespace

    out, gout = torch.empty_like(x_static), torch.empty_like(x_static)
    layer = SimpleNamespace(inputs=(x_static,), first=True, forwards=graphs._Forwards(),
                            fresh=False, outputs=(out,), grad_outputs=(gout,),
                            fwd_launches={}, bwd_launches={}, flat=flat, slices=[(0, 4)],
                            params=(w,), grad_inputs=(None,))
    layer.fwd = SimpleNamespace(replay=lambda: out.copy_(w.detach() * x_static))
    layer.bwd = SimpleNamespace(replay=lambda: flat.copy_(gout * x_static))
    return layer


def test_autograd_keeps_a_static_gradient_buffer_it_is_handed_as_grad():
    """Why the replay clones: a backward that hands autograd a detached
    static buffer (``make_graphed_callables``' does) finds it kept as
    ``.grad``, and the next micro-batch's replay overwrites the first's."""
    flat = torch.zeros(4)

    class Static(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            ctx.save_for_backward(x)
            return x * w

        @staticmethod
        def backward(ctx, g):
            (x,) = ctx.saved_tensors
            flat.copy_(g * x)
            return None, flat.detach()

    w = torch.nn.Parameter(torch.ones(4))
    Static.apply(torch.full((4,), 1.0), w).sum().backward()
    assert w.grad.data_ptr() == flat.data_ptr()
    Static.apply(torch.full((4,), 2.0), w).sum().backward()
    assert torch.equal(w.grad, torch.full((4,), 4.0))  # 1 + 2 would be right


def test_replayed_gradients_add_up_over_micro_batches():
    w = torch.nn.Parameter(torch.ones(4))
    x_static, flat = torch.zeros(4), torch.zeros(4)
    layer = _layer(w, x_static, flat)
    for x in (torch.full((4,), 1.0), torch.full((4,), 2.0)):
        (y,) = graphs._Replay.apply(layer, x, w)
        assert torch.equal(y, x)
        y.sum().backward()
    assert w.grad.data_ptr() != flat.data_ptr()
    assert torch.equal(w.grad, torch.full((4,), 3.0))
    # a micro-batch's input written into the static one is not copied again
    x_static.fill_(4.0)
    (y,) = graphs._Replay.apply(layer, x_static, w)
    assert torch.equal(y, torch.full((4,), 4.0))


def test_a_replayed_backward_must_follow_its_own_forward():
    w = torch.nn.Parameter(torch.ones(4))
    layer = _layer(w, torch.zeros(4), torch.zeros(4))
    (y,) = graphs._Replay.apply(layer, torch.ones(4), w)
    graphs._Replay.apply(layer, torch.ones(4), w)  # another forward in between
    with pytest.raises(RuntimeError, match="must follow its forward"):
        y.sum().backward()


# --- the step record's counts and the reader -------------------------------------


@pytest.mark.parametrize("acc", [1, 2])
def test_the_step_record_counts_the_layers_run_eagerly(ring, acc):
    model, step, batch = _tiny_trainer(pallas_augment=False, acc=acc)
    step(batch)
    (rec,) = ring.records
    assert (rec.graph_layers, rec.eager_layers) == (0, 3 * acc)
    assert profiling.record_json(rec, 0)["eager_layers"] == 3 * acc
    model(torch.zeros(1, 8, 32, 32, 3))  # outside a step: counted nowhere
    assert (rec.graph_layers, rec.eager_layers) == (0, 3 * acc) and ring.open is None


def _record(graphed, eager, profiled=False):
    rec = profiling.StepRecord(0, 0, profiled)
    rec.graph_layers, rec.eager_layers = graphed, eager
    return rec


def test_graph_share_reader(ring):
    read = load_reader("train_step.graph_share")
    assert read({}) is None  # an empty ring
    ring.records.extend([_record(3, 0), _record(6, 0), _record(0, 3), _record(3, 0)])
    ring.records.append(_record(0, 3, profiled=True))  # a traced step: left out
    assert read({}) == pytest.approx(12 / 15)
    ring.records.clear()
    ring.records.extend([_record(3, 0)] * 4)
    assert read({}) == 1.0


def test_graph_share_reader_reads_nothing_without_the_count(ring, monkeypatch):
    read = load_reader("train_step.graph_share")

    class Parent:  # the parent commit's record: no layer counts
        profiled = False

    ring.records.append(Parent())
    assert read({}) is None
    monkeypatch.delattr(profiling, "STEPS")
    assert read({}) is None


def test_reserved_memory_reader_reads_nothing_without_a_card(monkeypatch):
    read = load_reader("device.reserved_gib.train")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert read({}) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "max_memory_reserved", lambda *a: 3 * 2**30)
    assert read({}) == 3.0


# --- the graphs' memory pool ----------------------------------------------------


def _segment(pool, size, device=0):
    return {"device": device, "segment_pool_id": pool, "total_size": size}


SEGMENTS = [_segment((0, 0), 7 << 20), _segment((1, 0), 3 << 30), _segment([1, 0], 2 << 20),
            _segment((2, 0), 5 << 20, device=1), _segment((0, 4), 11 << 20)]


def _read_pool(monkeypatch, segments):
    read = load_reader("device.graph_pool_gib.train")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: segments)
    return read({})


def test_graph_pool_reader(monkeypatch):
    """The reader sums every segment outside the default pool, on every
    card and whatever form the pool's id takes, in GiB."""
    assert _read_pool(monkeypatch, SEGMENTS) == 3 + 18 / 1024


@pytest.mark.parametrize("segments", [[], [_segment((0, 0), 7 << 30)]])
def test_graph_pool_reader_leaves_out_the_default_pool(monkeypatch, segments):
    """The default pool holds the eager step's blocks: with no private
    pool the graphs hold nothing."""
    assert _read_pool(monkeypatch, segments) == 0.0


def test_graph_pool_reader_reads_nothing_without_the_count(monkeypatch):
    """Without a card the allocator keeps no count, and the reader asks
    for no snapshot."""
    read = load_reader("device.graph_pool_gib.train")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "memory_snapshot", lambda: pytest.fail("read a snapshot"))
    assert read({}) is None


# --- the draws reach the card without a host wait --------------------------------


def test_a_draw_bound_for_the_card_leaves_from_pinned_memory(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda self: calls.append("pin") or self)
    monkeypatch.setattr(torch.Tensor, "to",
                        lambda self, *a, **k: calls.append((a, k)) or self)
    x = torch.ones(3)
    step_module._upload(x, torch.device("cuda"))
    assert calls == ["pin", ((torch.device("cuda"),), {"non_blocking": True})]
    calls.clear()
    step_module._upload(x, torch.device("cpu"))  # on the CPU: no pinning
    assert calls == [((torch.device("cpu"),), {})]


def test_the_step_uploads_every_draw(monkeypatch):
    model, step, batch = _tiny_trainer(pallas_augment=False)
    (d,) = step.draw(batch)
    uploaded = []
    real = step_module._upload
    monkeypatch.setattr(step_module, "_upload",
                        lambda x, dev: uploaded.append(x) or real(x, dev))
    step(batch, [d])
    want = [d.lam, d.aug, *d.dropout_keep.values()]
    assert len(uploaded) == len(want) and all(u is w for u, w in zip(uploaded, want))


def test_k1_writes_into_a_given_tensor():
    g = torch.Generator().manual_seed(0)
    frames = torch.randint(0, 256, (1, 2, 8, 8, 3), generator=g, dtype=torch.uint8)
    params = augment.sample_params(g, 1)
    out = torch.empty(frames.shape, dtype=torch.bfloat16)
    got = augment.train_preprocess(frames, params, out)
    assert got is out and torch.equal(out, augment.train_preprocess(frames, params))
    with pytest.raises(ValueError, match="out must be"):
        augment.photometric(frames, params, torch.empty(frames.shape))
