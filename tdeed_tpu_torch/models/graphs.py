"""The model's three layers as CUDA graphs in training: the trunk
(``TDEED._trunk``), the temporal layer (``_temporal``) and the heads
(``_heads``), each captured once, forward and backward, and replayed.

A training step on the card issues some 4,000 kernels, nearly all of them
the trunk's forward and backward; where they are small the host takes
longer to issue them than the card to run them, and the card waits. A
replay issues a layer's kernels in one ``cudaGraphLaunch``. The same
kernels run on the same memory: only the issuing changes.

Where graphs hold (``eager_reason`` returns None): a train-mode forward
with grad on, on the card, with no process group and no
``checkpoint_backbone``. Elsewhere the layers run eagerly: serving,
validation, data parallelism, ``checkpoint_backbone``. So
do frames that need a gradient (the trunk graph gives its input none) and
a model with a frozen parameter (its capture differentiates them all).

``ModelGraphs`` keeps the graphs of one model by what it sees in its
input: the frames' shape and dtype and each dropout mask's (None where a
head takes none). A new key captures, up to ``MAX_KEYS``; past them the
layers run eagerly. The graphs hold the addresses of the parameters and
buffers they were captured with: a change of their storage (``model.to``,
an assignment to ``.data``) drops the graphs, in-place updates (AdamW,
``load_state_dict``) do not. A tensor put in a parameter's place
(``load_state_dict(assign=True)``) is not seen: nothing in the port does
that.

Capture (``_capture``), on a stream of the model's own: ``WARMUP`` eager
forwards and backwards first (cuDNN and cuBLAS set themselves up outside
a capture), with the running statistics frozen
(``models.common.frozen_running_stats``) and the gradients taken by
``torch.autograd.grad``, so the warm-up changes no parameter, gradient,
running statistic, batch count or optimizer state; then the forwards in
order and the backwards in reverse, into one memory pool. The warm-up's
memory, cached for the capture stream where the step cannot reuse it,
goes back to the card as each capture begins (``torch.cuda.graph``
empties the allocator's cache): without that a SoccerNet Ball capture
runs out of the card's memory. Each layer's static input is
the layer before's static output, and each backward's static cotangent
the backward after's static input gradient, so no replay copies between
layers. The trunk reads its frames from ``frames_buffer``, which the
training step's photometric kernel writes into. Neither warm-up nor
capture counts a kernel launch; a replay adds the launches its capture
recorded to each counter (``kernels/batchnorm``'s ``bn_*.launches``,
``kernels/upsample``'s ``upsample_*.launches``, ``kernels/se``'s
``se_*.launches``). The
BatchNorm kernels' ticket counters of the graphs are their own
(``batchnorm.captured_tickets``).

Replay (``_Replay``): an autograd function a layer that copies a
caller's input into the static one unless it is that tensor, replays the
forward, and in the backward copies the cotangents in, replays the
backward and hands autograd the gradients. The parameters' gradients
leave the graph as one flat buffer, cloned each replay: autograd keeps a
gradient it is handed as ``.grad`` where it finds none, and a static
buffer kept so would be overwritten by the next replay (the first
micro-batch's gradient with ``acc_grad_iter`` 2). The heads' outputs are
cloned too: the caller may keep them past the next step. The pool is
shared by all of a model's graphs, so a layer's backward must follow the
forward it belongs to with no other forward replayed between; the
backward raises otherwise.

Why not ``torch.cuda.make_graphed_callables``, which captures and
replays the same way: its backward hands autograd detached static
gradient buffers, the aliasing above, so gradient accumulation loses its
first micro-batch (tests/test_torch_graphs.py shows the mechanism on the
CPU). Besides, its warm-up writes the BatchNorms' running statistics and
batch counts, it captures on a stream of its own, which the BatchNorm
kernels' ticket counters would have to find, it takes as a graph's
inputs a module's parameters but not those a function reads (the trunk's
layout change, the heads of two modules and their masks), and it counts
no launch. Each of these is held on the card by
tests/test_torch_graphs_gpu.py: graphed steps against eager ones at
``acc_grad_iter`` 1 and 2 (gradients, changes, running statistics, batch
counts) and the graphs' ticket counters at zero after the replays.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from tdeed_tpu_torch.kernels import batchnorm, se, upsample
from tdeed_tpu_torch.models.common import frozen_running_stats
from tdeed_tpu_torch.parallel import mesh

MAX_KEYS = 4  # input keys captured a model; past them the layers run eagerly
WARMUP = 2  # eager forwards and backwards before a capture

# the kernel launch counters a replay adds its captured launches to
_COUNTERS = (batchnorm.bn_stats, batchnorm.bn_apply, batchnorm.bn_grad_sums,
             batchnorm.bn_grad_apply, upsample.upsample_forward, upsample.upsample_backward,
             se.se_excite, se.se_grad_sums, se.se_grad_apply)


def eager_reason(model, device) -> Optional[str]:
    """Why ``model``'s layers run eagerly for frames on ``device``, or None
    where its forward may replay graphs (the module docstring). Reads no
    parameter: a forward asks twice."""
    if not (model.training and torch.is_grad_enabled()):
        return "eval mode or grad off"
    if model.eager_only:
        return "checkpoint_backbone"
    if torch.device(device).type != "cuda":
        return "not on the card"
    if mesh.group_of(model) is not None:
        return "a process group"
    return None


@contextlib.contextmanager
def _uncounted(into: Dict):
    """Within, kernel launches add to ``into`` (counter -> launches) and
    leave the counters as they were."""
    before = [f.launches for f in _COUNTERS]
    try:
        yield
    finally:
        for f, n in zip(_COUNTERS, before):
            into[f] = into.get(f, 0) + f.launches - n
            f.launches = n


class _Forwards:
    """The count of graphed forwards a model's layers replayed."""

    __slots__ = ("n",)

    def __init__(self):
        self.n = 0


class _Layer:
    """One layer's captured forward and backward and their static
    tensors."""

    def __init__(self, forwards: _Forwards, params: Sequence[torch.nn.Parameter],
                 inputs: Sequence[Optional[torch.Tensor]], *, first: bool = False,
                 fresh: bool = False):
        self.forwards = forwards  # the model's, shared by its layers
        self.first = first  # the chain's first layer: its replay starts a forward
        self.params = tuple(params)
        self.inputs = tuple(inputs)
        self.fresh = fresh  # outputs cloned for the caller
        self.fwd = torch.cuda.CUDAGraph()
        self.bwd = torch.cuda.CUDAGraph()
        self.outputs: Tuple[torch.Tensor, ...] = ()
        self.grad_outputs: Tuple[torch.Tensor, ...] = ()
        self.grad_inputs: Tuple[Optional[torch.Tensor], ...] = ()
        self.flat: Optional[torch.Tensor] = None  # the parameters' gradients
        self.slices: List[Optional[Tuple[int, int]]] = []  # each one's (start, end) in flat
        self.fwd_launches: Dict = {}
        self.bwd_launches: Dict = {}

    def capture_forward(self, fn, pool, stream) -> None:
        with _uncounted(self.fwd_launches), torch.cuda.graph(
                self.fwd, pool=pool, stream=stream, capture_error_mode="thread_local"):
            out = fn(*self.inputs)
        self.outputs = out if isinstance(out, tuple) else (out,)

    def capture_backward(self, grad_outputs: Sequence[torch.Tensor], pool, stream) -> None:
        """Capture the backward from ``grad_outputs``, static cotangents
        the caller keeps; the outputs' autograd graph is spent."""
        self.grad_outputs = tuple(grad_outputs)
        wrt = [x for x in self.inputs if x is not None and x.requires_grad]
        with _uncounted(self.bwd_launches), torch.cuda.graph(
                self.bwd, pool=pool, stream=stream, capture_error_mode="thread_local"):
            grads = torch.autograd.grad(self.outputs, wrt + list(self.params),
                                        self.grad_outputs, allow_unused=True)
            used = [g.reshape(-1) for g in grads[len(wrt):] if g is not None]
            self.flat = torch.cat(used) if used else None
        it = iter(grads[:len(wrt)])
        self.grad_inputs = tuple(next(it) if x is not None and x.requires_grad else None
                                 for x in self.inputs)
        start = 0
        for g in grads[len(wrt):]:
            self.slices.append(None if g is None else (start, start + g.numel()))
            start += 0 if g is None else g.numel()
        self.outputs = tuple(o.detach() for o in self.outputs)

    def __call__(self, *inputs: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        return _Replay.apply(self, *inputs, *self.params)


def _count(launches: Dict) -> None:
    for f, n in launches.items():
        f.launches += n


class _Replay(torch.autograd.Function):
    """A captured layer as an autograd function of its inputs and
    parameters."""

    @staticmethod
    def forward(ctx, layer: _Layer, *args):
        inputs = args[:len(layer.inputs)]
        for static, x in zip(layer.inputs, inputs):
            if static is not None and x.data_ptr() != static.data_ptr():
                static.copy_(x)
        if layer.first:
            layer.forwards.n += 1
        layer.fwd.replay()
        _count(layer.fwd_launches)
        ctx.layer, ctx.forward = layer, layer.forwards.n
        if layer.fresh:
            return tuple(o.clone() for o in layer.outputs)
        return tuple(o.detach() for o in layer.outputs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *grads):
        layer = ctx.layer
        if ctx.forward != layer.forwards.n:
            raise RuntimeError("a graphed layer's backward must follow its forward with no "
                               "other forward of the model replayed between them")
        for static, g in zip(layer.grad_outputs, grads):
            if g.data_ptr() != static.data_ptr():
                static.copy_(g)
        layer.bwd.replay()
        _count(layer.bwd_launches)
        flat = None if layer.flat is None else layer.flat.clone()
        params = tuple(None if s is None else flat[s[0]:s[1]].view(p.shape)
                       for p, s in zip(layer.params, layer.slices))
        inputs = tuple(None if g is None else g.detach() for g in layer.grad_inputs)
        return (None, *inputs, *params)


class _Chain:
    """The three layers captured for one key, called in their order."""

    def __init__(self, trunk: _Layer, temporal: _Layer, heads: _Layer):
        self.trunk, self.temporal, self.heads = trunk, temporal, heads


class ModelGraphs:
    """A model's captured layers by input key (module docstring). Copies
    of the model start with none."""

    def __init__(self):
        self.chains: Dict[tuple, _Chain] = {}
        self.frames: Dict[tuple, torch.Tensor] = {}  # (shape, dtype) -> the trunk's input
        self.forwards = _Forwards()  # graphed forwards replayed
        self._pool = self._stream = self._tickets = None
        self._tensors: List[torch.Tensor] = []  # the parameters and buffers captured with
        self._storage: Optional[tuple] = None  # and their addresses

    def __deepcopy__(self, memo):
        return ModelGraphs()

    def _room(self, frames_key) -> bool:
        return (len(self.chains) < MAX_KEYS
                or any(k[:2] == frames_key for k in self.chains))

    def frames_buffer(self, model, shape: Sequence[int], dtype: torch.dtype,
                      device) -> Optional[torch.Tensor]:
        """The trunk graph's static input for frames of ``shape`` and
        ``dtype``, for the caller to write the frames into; None where the
        layers will run eagerly. The caller must be done with what it
        wrote (the backward run) before it writes again."""
        key = (tuple(shape), dtype)
        if eager_reason(model, device) is not None or not self._room(key):
            return None
        if key not in self.frames:
            self.frames[key] = torch.empty(key[0], dtype=dtype, device=device)
        return self.frames[key]

    def chain(self, model, frames: torch.Tensor,
              masks: Sequence[Optional[torch.Tensor]]) -> Optional[_Chain]:
        """The layers to replay for ``frames`` and the heads' ``masks``,
        captured now if new; None where they run eagerly."""
        if frames.requires_grad or eager_reason(model, frames.device) is not None:
            return None
        if self.chains and tuple(map(torch.Tensor.data_ptr, self._tensors)) != self._storage:
            self.chains.clear()
            self.frames.clear()
        key = (tuple(frames.shape), frames.dtype,
               tuple(None if m is None else (tuple(m.shape), m.dtype) for m in masks))
        chain = self.chains.get(key)
        if chain is None:
            if len(self.chains) >= MAX_KEYS or not all(p.requires_grad
                                                       for p in model.parameters()):
                return None
            if not self.chains:
                self._tensors = [*model.parameters(), *model.buffers()]
                self._storage = tuple(map(torch.Tensor.data_ptr, self._tensors))
            chain = self.chains[key] = self._capture(model, frames, masks)
        return chain

    def _capture(self, model, frames: torch.Tensor,
                 masks: Sequence[Optional[torch.Tensor]]) -> _Chain:
        dev = frames.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(dev)
            self._tickets = batchnorm.graph_tickets(dev)
        static = self.frames_buffer(model, frames.shape, frames.dtype, dev)
        if static.data_ptr() != frames.data_ptr():
            static.copy_(frames)
        masks = tuple(None if m is None else m.clone() for m in masks)
        params = model.layer_parameters()
        stream, pool = self._stream, self._pool
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            with frozen_running_stats(model), _uncounted({}):
                for _ in range(WARMUP):
                    ys = model._heads(model._temporal(model._trunk(static)), *masks)
                    torch.autograd.grad(ys, [p for ps in params for p in ps],
                                        [torch.ones_like(y) for y in ys], allow_unused=True)
                del ys
            with batchnorm.captured_tickets(self._tickets, stream.cuda_stream):
                trunk = _Layer(self.forwards, params[0], (static,), first=True)
                trunk.capture_forward(model._trunk, pool, stream)
                feat = trunk.outputs[0].detach().requires_grad_()
                temporal = _Layer(self.forwards, params[1], (feat,))
                temporal.capture_forward(model._temporal, pool, stream)
                feat = temporal.outputs[0].detach().requires_grad_()
                heads = _Layer(self.forwards, params[2], (feat, *masks), fresh=True)
                heads.capture_forward(model._heads, pool, stream)
                heads.capture_backward([torch.empty_like(y) for y in heads.outputs],
                                       pool, stream)
                temporal.capture_backward(heads.grad_inputs[:1], pool, stream)
                trunk.capture_backward(temporal.grad_inputs[:1], pool, stream)
        torch.cuda.current_stream(dev).wait_stream(stream)
        return _Chain(trunk, temporal, heads)
