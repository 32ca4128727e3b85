"""Host-side input pipeline: random clip sampling, threaded decode,
batching, and asynchronous copies to the device.

The port's own copy of ``FrameCache``, ``ClipSampler``, ``JointSampler``,
``_collate`` and ``BatchLoader`` from ``tdeed_tpu/data/loader.py`` (held
equal by tests/test_torch_infer_copies.py, tests/test_torch_train_copies.py
and tests/test_torch_soccernet_copies.py).
A thread pool decodes (JPEG decode releases the GIL in every backend) and
a bounded queue holds assembled batches, so decode and batch assembly
overlap the device's work. Sampling ignores the index and draws a uniform
random stored clip, so the epoch length is virtual: dataset_len =
epoch_num_frames // clip_len (ref: dataset/frame.py:210-253,
dataset/datasets.py:22). ``device_prefetch`` is the port's own: pinned
host copies, moved to the CUDA device without blocking the host.
"""

from __future__ import annotations

import collections
import queue
import random
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from tdeed_tpu_torch.data.clips import ClipPlan, rasterize_labels
from tdeed_tpu_torch.data.frames import get_decoder, load_clip


class FrameCache:
    """Bounded decoded-frame LRU shared by all sampler/decoder threads.

    Why it wins: training clips resample from a FIXED stored plan whose
    windows overlap ~90% (ref: dataset/frame.py:116,210-241), and
    evaluation windows overlap 75% (registry.DatasetSpec.eval_overlap_len),
    so the same frame file is decoded into many clips; serving repeats from
    memory cuts decode work ~hit-rate fold.

    Correctness argument:
      * keyed by absolute frame path; frame stores are immutable during a
        run and one run uses ONE decoder backend (cfg.decoder), so a path
        fully determines the decoded pixels;
      * cached values are frozen (``writeable=False``) contiguous copies,
        and every consumer copies rows into freshly allocated buffers
        (``np.stack`` in frames.load_window) — a batch can never alias or
        mutate the cache;
      * stride/pad layout is applied OUTSIDE the cache (per-clip), so the
        same cached frame serves clips of any stride/padding.

    Thread safety: one lock around the OrderedDict; decode happens outside
    the lock, so concurrent misses on the same path may decode twice —
    harmless (identical bytes; last insert wins).
    """

    def __init__(self, capacity_bytes: int):
        assert capacity_bytes > 0
        self.capacity_bytes = int(capacity_bytes)
        self._lock = threading.Lock()
        self._data: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0

    def get(self, path: str) -> Optional[np.ndarray]:
        with self._lock:
            arr = self._data.get(path)
            if arr is None:
                self.misses += 1
            else:
                self._data.move_to_end(path)
                self.hits += 1
            return arr

    def put(self, path: str, arr: np.ndarray) -> None:
        if arr.nbytes > self.capacity_bytes:
            return
        arr = np.ascontiguousarray(arr)
        arr.flags.writeable = False
        with self._lock:
            if path in self._data:
                self._data.move_to_end(path)
                return
            self._data[path] = arr
            self._bytes += arr.nbytes
            while self._bytes > self.capacity_bytes:
                _, old = self._data.popitem(last=False)
                self._bytes -= old.nbytes

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._data),
                "bytes": self._bytes,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
            }


class ClipSampler:
    """Uniform random sampler over a stored clip plan (one dataset split)."""

    def __init__(
        self,
        plan: ClipPlan,
        clip_len: int,
        stride: int,
        radi_displacement: int,
        mixup: bool,
        decoder: Callable[[str], np.ndarray] = None,
        dataset_tag: Optional[int] = None,
        cache: Optional[FrameCache] = None,
    ):
        assert len(plan) > 0
        self.plan = plan
        self.clip_len = clip_len
        self.stride = stride
        self.radi = radi_displacement
        self.mixup = mixup
        self.decoder = decoder or get_decoder()
        self.dataset_tag = dataset_tag
        self.cache = cache

    def _get_one(self, rng: random.Random) -> Dict[str, np.ndarray]:
        idx = rng.randint(0, len(self.plan) - 1)  # ref: frame.py:212
        frames = load_clip(
            self.plan.frame_paths[idx], self.stride, self.decoder, pad=True,
            cache=self.cache,
        )
        labels, labels_d = rasterize_labels(
            self.plan.labels[idx],
            self.plan.labels_d[idx] if self.plan.labels_d is not None else None,
            self.clip_len,
        )
        out = {"frame": frames, "label": labels.astype(np.int32)}
        if labels_d is not None:
            out["labelD"] = labels_d.astype(np.float32)
        return out

    def sample(self, rng: random.Random) -> Dict[str, np.ndarray]:
        ret = self._get_one(rng)
        if self.mixup:
            mix = self._get_one(rng)  # ref: frame.py:244-252
            ret["frame2"] = mix["frame"]
            ret["label2"] = mix["label"]
            if "labelD" in mix:
                ret["labelD2"] = mix["labelD"]
        if self.dataset_tag is not None:
            ret["dataset"] = np.int32(self.dataset_tag)
        return ret


class JointSampler:
    """50/50 two-dataset sampler tagging the source
    (ref: dataset/frame.py:640-663)."""

    def __init__(self, sampler1: ClipSampler, sampler2: ClipSampler):
        self.s1 = sampler1
        self.s2 = sampler2
        self.s1.dataset_tag = 1
        self.s2.dataset_tag = 2

    def sample(self, rng: random.Random) -> Dict[str, np.ndarray]:
        return (self.s1 if rng.random() < 0.5 else self.s2).sample(rng)


def _collate(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], axis=0) for k in keys}


class BatchLoader:
    """Threaded epoch iterator yielding host numpy batches.

    num_batches per epoch = dataset_len // batch_size; each batch's samples
    decode in parallel on the pool, and up to `prefetch` assembled batches
    wait in a bounded queue.
    """

    def __init__(
        self,
        sampler,
        batch_size: int,
        dataset_len: int,
        num_workers: int = 8,
        prefetch: int = 4,
        seed: int = 1,
        global_batch_size: Optional[int] = None,
        shard_offset: int = 0,
    ):
        """batch_size is the LOCAL batch this loader materializes.

        Multi-host DP: pass the GLOBAL batch size and this host's row
        offset. Sample RNGs derive from the global row index, so the union
        of all hosts' loaders reproduces the single-host epoch bit-for-bit
        (host h materializes rows [h*local, (h+1)*local) of every global
        batch). Single-host: defaults make both equal to batch_size/0.
        """
        self.sampler = sampler
        self.batch_size = batch_size
        self.global_batch_size = global_batch_size or batch_size
        self.shard_offset = shard_offset
        assert self.shard_offset + batch_size <= self.global_batch_size
        # Sample RNGs are keyed base*1e6+3 + batch*1009 + global_row: rows
        # must stay below the batch multiplier or keys collide across
        # neighbouring batches.
        assert self.global_batch_size < 1009, self.global_batch_size
        self.num_batches = max(1, dataset_len // self.global_batch_size)
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self._epoch = 0

    def __len__(self) -> int:
        return self.num_batches

    def epoch(
        self, epoch: Optional[int] = None, start_batch: int = 0
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield the epoch's batches, optionally skipping the first
        ``start_batch`` (step-level resume: batch b of epoch e is a pure
        function of (seed, e, b), so a resumed run sees exactly the batches
        the interrupted one would have)."""
        if epoch is None:
            epoch = self._epoch
            self._epoch += 1
        base_seed = hash((self.seed, epoch)) & 0x7FFFFFFF
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """Bounded put that observes `stop`: a consumer abandoning the
            generator mid-epoch (exception, break) must not strand the
            producer in q.put with the queue full — that leaks the thread,
            the decode pool, and `prefetch` decoded batches per abort."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for b in range(start_batch, self.num_batches):
                        if stop.is_set():
                            break
                        rngs = [
                            random.Random(
                                base_seed * 1_000_003 + b * 1009
                                + self.shard_offset + i
                            )
                            for i in range(self.batch_size)
                        ]
                        futs = [pool.submit(self.sampler.sample, r) for r in rngs]
                        if not put_or_stop(_collate([f.result() for f in futs])):
                            return
            except Exception as e:  # propagate to consumer
                put_or_stop(e)
                return
            put_or_stop(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()


def device_prefetch(iterator, device, depth: int = 2):
    """Move batches (dicts of numpy arrays or tensors) to ``device`` ahead
    of their use, keeping ``depth`` batches in flight.

    For a CUDA device each host array is copied into pinned memory and
    moved with ``non_blocking=True`` on the current stream, so the copy
    overlaps the device's work and the step that reads it is ordered after
    it. PyTorch's pinned-memory allocator reuses a pinned block only once
    the copies that read it have finished, so a batch is never overwritten
    in flight. A tensor already on the card passes through unchanged; on
    the CPU the arrays become tensors without a copy."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    buf = collections.deque()

    def put(batch):
        out = {}
        for k, x in batch.items():
            t = torch.as_tensor(x)
            if cuda and t.device.type == "cpu":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        return out

    for batch in iterator:
        buf.append(put(batch))
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
