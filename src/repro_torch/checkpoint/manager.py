"""Checkpoint manager: rotation, saves on a background thread, and resume,
the port of the JAX package's ``repro/checkpoint/manager.py``.

* ``save(step, tree)`` copies the tree to the host on the caller's thread
  (a snapshot: later changes to the tensors do not reach the file), then a
  worker thread writes it; an error there surfaces at the next ``save()``
  or ``wait()``. ``wait()`` drains the queue.
* keeps the newest ``max_to_keep`` checkpoints and every ``keep_period``-th.
* ``restore_or_init(init_fn)`` loads the latest checkpoint if there is one,
  else returns ``init_fn()`` at step -1: a stopped run re-enters here.
"""
from __future__ import annotations

import os
import queue
import shutil
import threading
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint.checkpointer import (latest_step, load_checkpoint,
                                                 save_checkpoint, step_dir)
from repro_torch.utils import tree_map


def _snapshot(leaf):
    """A host copy of a tensor leaf (``.cpu()`` alone returns the same
    tensor on the CPU, which a later in-place update would change)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return leaf


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, keep_period: int = 0,
                 async_saves: bool = True):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period
        self.async_saves = async_saves
        self._q: "queue.Queue" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any):
        if self._error:
            raise RuntimeError("previous async save failed") from self._error
        if not self.async_saves:
            save_checkpoint(self.directory, step, tree)
            self._gc()
            return
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._drain, daemon=True)
            self._worker.start()
        self._q.put((step, tree_map(_snapshot, tree)))

    def _drain(self):
        while True:
            step, tree = self._q.get()
            try:
                save_checkpoint(self.directory, step, tree)
                self._gc()
            except Exception as e:  # surfaced on the next save() / wait()
                self._error = e
            finally:
                self._q.task_done()

    def wait(self):
        if self._worker is not None and self._worker.is_alive():
            self._q.join()
        if self._error:
            raise RuntimeError("async save failed") from self._error

    # -- restore -------------------------------------------------------------
    def restore_or_init(self, init_fn: Callable[[], Any]):
        """(tree, step); step = -1 for a fresh start."""
        tree = init_fn()
        step = latest_step(self.directory)
        if step is None:
            return tree, -1
        return load_checkpoint(self.directory, tree, step)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    # -- rotation -------------------------------------------------------------
    def _gc(self):
        steps = sorted(int(d[len("step_"):]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        keep = set(steps[-self.max_to_keep:]) if self.max_to_keep > 0 else set(steps)
        if self.keep_period:
            keep |= {s for s in steps if s % self.keep_period == 0}
        for s in steps:
            if s not in keep:
                shutil.rmtree(step_dir(self.directory, s), ignore_errors=True)
