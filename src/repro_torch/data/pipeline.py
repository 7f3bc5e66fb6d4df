"""Host data pipeline with a background prefetch thread, the port of the
JAX package's ``data/pipeline.py``.

The pipeline is step-indexed and deterministic: batch ``step`` is
``batch_fn(step)``, so a resumed run sees the batches an uninterrupted one
would. A prefetch thread makes batches ahead of the consumer. Setting
``step`` forward (a resume seek) makes ``next()`` drop the batches made for
earlier steps. Batches come out as tensors on ``device`` (CPU tensors when
it is None). Like the JAX CLI, the training CLI does not use it.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable

import torch


class DataPipeline:
    def __init__(self, batch_fn: Callable[[int], dict], device=None,
                 prefetch: int = 2, start_step: int = 0):
        self.batch_fn = batch_fn
        self.device = device
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _place(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def _producer(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.batch_fn(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.5)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        while True:
            step, batch = self._q.get()
            if step < self.step:  # stale after a resume seek
                continue
            self.step = step + 1
            return step, self._place(batch)

    def __iter__(self):
        return self

    def close(self):
        """Stop the prefetch thread and wait for it to end."""
        self._stop.set()
        self._thread.join()
