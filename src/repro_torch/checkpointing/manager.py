"""Checkpoint manager: atomic, async, restartable (the counterpart of
``src/repro/checkpointing/manager.py``, in its layout).

Layout: ``<dir>/step_<N>/`` with one ``.npy`` per tree leaf plus a
``manifest.json`` (each leaf's path, shape and dtype).  Writes go to
``step_<N>.tmp`` and are atomically renamed, so a crash mid-save never
corrupts the restore point.  ``save`` copies every leaf to host memory
before it returns, then writes on a background thread; ``wait()`` joins it
before the next save, a restore, or at exit.  A CUDA leaf is copied into a
pinned host buffer that the manager keeps and reuses from save to save
(so a save first waits for the previous write to finish with it): on the
H100's host a fresh pageable copy of llama3.2-1b's 12.4 GB training state
ran at 2.1 GB/s, a copy into reused pinned buffers at 54, and one thread
wrote the files at 3 GB/s (PERF.md §5): the leaf files are written and
read by IO_THREADS threads side by side.

A save still being written counts as taken: :meth:`all_steps` and
:meth:`latest_step` wait for it.  (The reference's list only what is
published, so its restart loop, failing while the last save is still on
its thread, finds no checkpoint and restarts cold.)

Leaf keys are the reference's (:mod:`repro_torch.tree`), so a checkpoint
of the LM parameters and AdamW state written by the reference restores
into the port's trees of the same structure.

bfloat16.  numpy has no bfloat16: a bfloat16 leaf is saved as its uint16
bit pattern, with ``"bfloat16"`` in the manifest as the reference writes
it, and restored bit for bit.  The reference saves the same leaf as a
2-byte void array (``|V2``) and cannot read it back itself; restore here
reads either file.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tree as T

BF16 = "bfloat16"
#: threads that write (or read) a checkpoint's leaf files side by side
IO_THREADS = 8


def _numpy(t: torch.Tensor):
    """A host tensor's numpy view (no copy) and its manifest dtype."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _tensor(arr, dtype_name):
    if dtype_name == BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._pinned: Dict[str, torch.Tensor] = {}

    # ------------------------------------------------------------ save
    def _snapshot(self, tree):
        """Every leaf as a finished host copy that no later change of the
        leaf reaches: ``[(key, array, dtype name)]``."""
        out, on_cuda = [], False
        for key, v in T.leaves_with_paths(tree):
            if isinstance(v, torch.Tensor) and v.is_cuda:
                buf = self._pinned.get(key)
                if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                    buf = self._pinned[key] = torch.empty(v.shape, dtype=v.dtype,
                                                          pin_memory=True)
                buf.copy_(v.detach(), non_blocking=True)
                out.append((key, buf))
                on_cuda = True
            elif isinstance(v, torch.Tensor):
                out.append((key, v.detach().to("cpu", copy=True)))
            else:
                out.append((key, torch.from_numpy(np.array(v))))
        if on_cuda:
            torch.cuda.synchronize()
        return [(k, *_numpy(t)) for k, t in out]

    def save(self, step: int, tree: Any, *, async_: bool = True):
        # the previous write has finished with the pinned buffers; snapshot
        # to host memory synchronously, write async
        self.wait()
        host = self._snapshot(tree)
        if async_:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _write(self, step: int, host):
        tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
        final = os.path.join(self.dir, f"step_{step:09d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {}
        with ThreadPoolExecutor(IO_THREADS) as pool:
            futures = []
            for i, (key, arr, dtype_name) in enumerate(host):
                fname = f"leaf_{i:05d}.npy"
                futures.append(pool.submit(np.save, os.path.join(tmp, fname), arr))
                manifest[key] = {"file": fname, "shape": list(arr.shape),
                                 "dtype": dtype_name}
            for fut in futures:
                fut.result()
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic publish
        self._gc()

    def _gc(self):
        steps = self._published()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # ------------------------------------------------------------ restore
    def all_steps(self):
        """Every checkpointed step, the one being written included."""
        self.wait()
        return self._published()

    def _published(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None):
        """Restore into the structure of ``tree_like`` (values replaced):
        each tensor leaf on the device and in the dtype of ``tree_like``'s
        leaf.  Returns (tree, step)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        flat = T.leaves_with_paths(tree_like)
        metas = [manifest[key] for key, _ in flat]
        leaves = []
        with ThreadPoolExecutor(IO_THREADS) as pool:
            arrays = pool.map(np.load, [os.path.join(d, m["file"]) for m in metas])
            for (_, ref), meta, arr in zip(flat, metas, arrays):
                t = _tensor(arr, meta["dtype"])
                if isinstance(ref, torch.Tensor):
                    t = t.to(device=ref.device, dtype=ref.dtype)
                leaves.append(t)
        return T.unflatten(tree_like, leaves), step
