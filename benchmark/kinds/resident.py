"""Training on batches resident on the card: the step, the model and K1
do the work, and no host loader stands in the way.

Traffic parameters (``benchmark/traffic/<mix>.json``):
  batches       distinct batches made on the card from the seed, cycled;
                the first three are the check's steps, so at least 3
  event_share   the share of labelled frames that hold an event

Each clip of a configuration with two heads is tagged for head 1 or 2 at
50/50, as the joint sampler of the published training draws it; a clip's
labels are its head's.

Set-up builds the training step once, drives it from the seed through
three steps with the benchmark's own random draws (each step a different
batch) and one more with the program's, and keeps, of the first three,
each step's loss, each tensor's first gradient (from AdamW's first moment
after one step) and each tensor's change. The window then calls the same
step back to back. ``check`` works the three steps out again in the
reference and returns the gaps.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import torch

from benchmark import compare, cuda, roofline
from benchmark.reference import model as M, train as R
from benchmark.trace import profile, reduce

TRACED_STEPS = 3
CHECK_STEPS = 3


def _schedule(cfg) -> Dict[str, int]:
    """The training CLI's schedule: warm-up and cosine lengths in
    optimizer steps from the configuration's epochs."""
    per_epoch = cfg.dataset_len // cfg.batch_size
    return {"warmup_steps": cfg.warm_up_epochs * per_epoch,
            "cosine_steps": (cfg.num_epochs - cfg.warm_up_epochs) * per_epoch}


def textured(gen: torch.Generator, b: int, t: int, h: int, w: int) -> torch.Tensor:
    """(b, t, h, w, 3) uint8 frames on the generator's device: per clip a
    pattern of waves at drawn frequencies and phase that moves from frame
    to frame, plus noise: camera-like content (the program's
    ``tools/measure.py`` ``synth_tree`` draws its JPEGs alike). White noise
    would not do: it drives every filter of the trunk at once, and its
    rounding reads as a different model."""
    dev = gen.device
    yy = torch.arange(h, device=dev, dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device=dev, dtype=torch.float32).view(1, 1, w)
    tt = torch.arange(t, device=dev, dtype=torch.float32).view(t, 1, 1)
    out = torch.empty(b, t, h, w, 3, device=dev, dtype=torch.uint8)
    for i in range(b):
        fx, fy, ph = (9 + 16 * torch.rand(2, generator=gen, device=dev)).tolist() + \
            (6 * torch.rand(1, generator=gen, device=dev)).tolist()
        base = 128 + 80 * torch.sin(xx / fx + tt / 3.0 + ph) + 60 * torch.cos(yy / fy - tt / 5.0)
        img = torch.stack([base, base.roll(3, dims=2), base.flip(1)], dim=-1)
        img += 12 * torch.randn(img.shape, generator=gen, device=dev)
        out[i] = img.clamp_(0, 255).to(torch.uint8)
    return out


def make_batches(gen: torch.Generator, n: int, cfg, frame_hw, two_heads,
                 event_share: float) -> List[Dict[str, torch.Tensor]]:
    """``n`` mixup batches on the generator's device: textured uint8
    frames, labels (0 for no event) and displacements for both streams,
    and with two heads each clip's head, 1 or 2, at 50/50."""
    dev = gen.device
    b, t = cfg.batch_size, cfg.clip_len
    h, w = frame_hw
    radi = cfg.radi_displacement

    def labels(n_cls):
        event = torch.rand(b, t, generator=gen, device=dev) < event_share
        cls = 1 + (torch.rand(b, t, generator=gen, device=dev) * (n_cls[:, None] - 1)).long()
        return torch.where(event, cls, torch.zeros_like(cls)).int()

    out = []
    for _ in range(n):
        batch = {}
        if two_heads:
            head = 1 + (torch.rand(b, generator=gen, device=dev) < 0.5).int()
            batch["dataset"] = head
            n_cls = torch.where(head == 1, two_heads[0], two_heads[1])
        else:
            n_cls = torch.full((b,), cfg.num_classes + 1, device=dev)
        for sfx in ("", "2"):
            batch["frame" + sfx] = textured(gen, b, t, h, w)
            batch["label" + sfx] = labels(n_cls)
            batch["labelD" + sfx] = torch.randint(-radi, radi + 1, (b, t), generator=gen,
                                                  device=dev).float()
        out.append(batch)
    return out


def _maybe_float(t):
    return None if t is None else t.detach().float()


def norms(tensors) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.float())) for n, t in tensors}


class Trainer:
    """The program's training step built from a configuration file and a
    seed, with the benchmark's weights, and what the check needs of it."""

    def __init__(self, cfg_file: dict, seed: int, device: str):
        from tdeed_tpu_torch.config import TDEEDConfig
        from tdeed_tpu_torch.models.tdeed import build_model, two_heads_for
        from tdeed_tpu_torch.train.schedule import make_optimizer
        from tdeed_tpu_torch.train.step import make_train_step

        self.device = device
        cfg = self.cfg = TDEEDConfig.from_dict(cfg_file)
        self.two_heads = two_heads_for(cfg)
        self.spec = M.Spec.of(cfg_file, self.two_heads)
        self.gen = torch.Generator(device).manual_seed(seed)
        self.weights = M.init_weights(self.spec, self.gen)
        model = self.model = build_model(cfg, self.two_heads, device=device)
        state = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
        if state != set(self.weights):
            raise RuntimeError(f"the program's state and the reference's differ: "
                               f"{sorted(state ^ set(self.weights))[:5]}")
        model.load_state_dict(self.weights, strict=False)
        self.sched = _schedule(cfg)
        opt, sched = make_optimizer(model.parameters(), cfg.learning_rate, **self.sched)
        self.opt = opt
        self.step = make_train_step(
            model, opt, sched, crop_dim=cfg.crop_dim, num_classes_bg=cfg.num_classes_bg,
            mixup=cfg.mixup, radi_displacement=cfg.radi_displacement,
            acc_grad_iter=cfg.acc_grad_iter, seed=seed)
        self.hw = tuple(cfg_file["frame_hw"])
        host = torch.Generator().manual_seed(seed)
        self.draws = [R.draw(host, cfg.batch_size, cfg.clip_len, self.hw, cfg.crop_dim,
                             cfg.mixup, self.spec.feat_dim, model.dropout_heads)
                      for _ in range(CHECK_STEPS)]
        crop = (cfg.crop_dim, cfg.crop_dim) if cfg.crop_dim else self.hw
        self.frames_per_step = cfg.batch_size * cfg.clip_len
        self.readings = {
            "flops_per_step": 3 * roofline.forward_flops(self.spec, self.frames_per_step, *crop),
            "k1_shape": (cfg.batch_size, cfg.clip_len, *crop, 3),
            "k1_in_bytes": 2 if cfg.mixup else 1,
        }

    def check_steps(self, batches) -> dict:
        """The check's steps, one a batch with the benchmark's draws: each
        step's loss, each tensor's first gradient (from AdamW's first
        moment after one step), each tensor's change over the steps, and
        the first step's logits and displacements (the model's outputs in
        that step's forward)."""
        from tdeed_tpu_torch.train.step import StepDraws

        model, opt = self.model, self.opt
        p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
        beta1 = opt.defaults["betas"][0]
        losses, outputs = [], []
        hook = model.register_forward_hook(lambda m, args, out: outputs.append(
            (out["logits"].detach().float(), _maybe_float(out.get("displ")))))
        for i, (batch, d) in enumerate(zip(batches, self.draws)):
            out = self.step(batch, [StepDraws(d.crop, d.lam, d.aug, d.keep)])
            losses.append(float(out["loss"]))
            if i == 0:
                hook.remove()
                # an optimizer that kept no moment holds no gradient: norm 0
                grad = norms((n, opt.state[p].get("exp_avg", torch.zeros(())) / (1 - beta1))
                             for n, p in model.named_parameters())
        change = norms((n, p.detach() - p0[n]) for n, p in model.named_parameters())
        return {"losses": losses, "grad": grad, "change": change, "outputs": outputs[0]}

    def free(self) -> None:
        """Drop the program's state: the reference runs after it."""
        self.step = self.model = self.opt = None
        gc.collect()
        cuda.empty_cache(self.device)

    def reference(self, batches, quant: M.Quant = None) -> dict:
        """The check's steps worked out by the reference on ``batches``,
        float32 with TF32 off (or through ``quant``): losses and norms."""
        cfg = self.cfg
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            tr = R.train(self.weights, self.spec, batches, self.draws,
                         crop_dim=cfg.crop_dim, mixup=cfg.mixup, lr=cfg.learning_rate,
                         checkpoint=True, quant=quant, **self.sched)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        return {"losses": tr.losses, "grad": norms(tr.grad.items()),
                "change": norms(tr.change.items()),
                "outputs": tuple(_maybe_float(o) for o in tr.outputs)}


class Cell:
    """One run of a training cell: set-up in the constructor, then
    ``window``, optionally ``traced``, then ``check``."""

    def __init__(self, cfg_file: dict, mix: dict, seed: int, device: str = "cuda"):
        if mix["batches"] < CHECK_STEPS:
            raise ValueError(f"the check's {CHECK_STEPS} steps take {CHECK_STEPS} batches")
        self.device = device
        t = self.trainer = Trainer(cfg_file, seed, device)
        self.batches = make_batches(t.gen, mix["batches"], t.cfg, t.hw, t.two_heads,
                                    mix["event_share"])
        self.readings = t.readings
        self.program = t.check_steps(self.batches[:CHECK_STEPS])
        self._i = CHECK_STEPS
        self.attempted = self.failed = 0
        self._run(1)  # one step with the program's own draws
        cuda.sync(device)

    def _run(self, n: int) -> None:
        for _ in range(n):
            with torch.profiler.record_function("bench.step"):
                self.trainer.step(self.batches[self._i % len(self.batches)])
            self._i += 1

    def window(self, seconds: float) -> Dict[str, float]:
        """Steps back to back for ``seconds``; the frames trained over the
        window's seconds, the window ending in a synchronise."""
        cuda.sync(self.device)
        cuda.reset_peak(self.device)
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < seconds:
            self._run(1)
            n += 1
        cuda.sync(self.device)
        dt = time.perf_counter() - t0
        self.attempted = n
        self.readings.update(unit_s=dt / n, peak_bytes_window=cuda.peak(self.device))
        return {"train_frames_per_s": n * self.trainer.frames_per_step / dt}

    def traced(self) -> dict:
        """TRACED_STEPS steps under the profiler, after one traced and
        thrown away, each from an idle device."""
        with profile(warmup=1) as prof:
            for _ in range(1 + TRACED_STEPS):
                self._run(1)
                cuda.sync(self.device)
                prof.step()
        self.readings.update(trace=reduce(prof), units_traced=TRACED_STEPS)
        return self.readings["trace"]

    def free(self) -> None:
        self.trainer.free()

    def reference(self, quant: M.Quant = None) -> dict:
        return self.trainer.reference(self.batches[:CHECK_STEPS], quant)

    def check(self) -> Dict[str, float]:
        self.free()
        return compare.training_gaps(self.program, self.reference())
