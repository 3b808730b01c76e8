"""Sharded host data pipeline: background prefetch and device placement,
with the batch laid out over a mesh when one is given (the counterpart of
``src/repro/data/pipeline.py``)."""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import torch

from torch.distributed.tensor import distribute_tensor

from repro_torch import tree as T
from repro_torch.device import resolve
from repro_torch.launch.mesh import placements


class PrefetchLoader:
    """Wraps a host batch iterator with a background prefetch thread that
    keeps up to ``depth`` batches ready, and places each batch on
    ``device`` as it is taken: a CUDA device gets it through pinned host
    memory and a copy that does not block the host.  With a ``mesh`` (a
    ``DeviceMesh``) and a ``spec`` (a :class:`repro_torch.tree.P`, e.g.
    ``P(("data",), None)``) every leaf becomes a DTensor of that layout
    on the mesh's device: each rank keeps its own shard of the host batch
    that every rank holds whole."""

    def __init__(self, it: Iterator, mesh=None, spec=None, device="cuda", depth: int = 2):
        self.it = it
        self.mesh, self.spec = mesh, spec
        self.device = resolve(mesh.device_type if mesh is not None else device)
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _place(self, batch):
        def put(x):
            t = torch.as_tensor(x)
            if self.device.type != "cuda":
                t = t.to(self.device)
            else:
                t = t.pin_memory().to(self.device, non_blocking=True)
            if self.mesh is None:
                return t
            return distribute_tensor(t, self.mesh, placements(self.spec, self.mesh, t.ndim),
                                     src_data_rank=None)
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
