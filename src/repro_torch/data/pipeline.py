"""Host data pipeline: background prefetch and device placement (the
counterpart of ``src/repro/data/pipeline.py`` on one device; the batch
sharding over a mesh waits for the mesh, ``ROADMAP.md`` open item 1)."""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import torch

from repro_torch import tree as T
from repro_torch.device import resolve


class PrefetchLoader:
    """Wraps a host batch iterator with a background prefetch thread that
    keeps up to ``depth`` batches ready, and places each batch on
    ``device`` as it is taken: a CUDA device gets it through pinned host
    memory and a copy that does not block the host."""

    def __init__(self, it: Iterator, device="cuda", depth: int = 2):
        self.it = it
        self.device = resolve(device)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _place(self, batch):
        def put(x):
            t = torch.as_tensor(x)
            if self.device.type != "cuda":
                return t.to(self.device)
            return t.pin_memory().to(self.device, non_blocking=True)
        return T.tree_map(put, batch)

    def _worker(self):
        for batch in self.it:
            if self._stop.is_set():
                return
            self.q.put(batch)

    def __iter__(self):
        return self

    def __next__(self):
        batch = self.q.get()
        return self._place(batch)

    def close(self):
        self._stop.set()
