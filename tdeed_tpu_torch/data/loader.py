"""Decoded-frame cache for the host input path.

The port's own copy of ``FrameCache`` from ``tdeed_tpu/data/loader.py``
(held equal by tests/test_torch_infer_copies.py). The training loader
around it (clip sampling, threaded decode, device prefetch) is not ported
yet (ROADMAP.md, port queue: checkpoint and the CLIs).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np


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
