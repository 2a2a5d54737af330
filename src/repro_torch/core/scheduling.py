"""Scheduling strategies (survey §3.2.8, Table 8).

* :class:`PipelinedLoader` — AGL-style: the sampling/preprocessing stage
  runs in worker threads in parallel with model computation; after a few
  iterations training time ≈ model-compute time.

The reference's ``WorkStealingPool`` and ``cost_balanced_assignment``
serve the distributed paths and are not ported yet.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable


class _Failed:
    def __init__(self, exc: Exception):
        self.exc = exc


class PipelinedLoader:
    """Prefetching iterator: ``sample_fn()`` runs in ``n_workers`` threads
    while the consumer trains (AGL §3.2.8: 'schedules the two stages in
    parallel').

    An exception in ``sample_fn`` is handed to the consumer, whose next
    ``next()`` raises it (the reference's worker dies and leaves the
    consumer waiting forever)."""

    def __init__(self, sample_fn: Callable[[], object], *, depth: int = 4,
                 n_workers: int = 1):
        self.sample_fn = sample_fn
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.stop = threading.Event()
        self.idle_s = 0.0
        self.workers = [threading.Thread(target=self._work, daemon=True)
                        for _ in range(n_workers)]
        for w in self.workers:
            w.start()

    def _work(self):
        while not self.stop.is_set():
            try:
                item = self.sample_fn()
            except Exception as exc:  # noqa: BLE001 -- raised by __next__
                item = _Failed(exc)
            while not self.stop.is_set():
                try:
                    self.q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        item = self.q.get()
        self.idle_s += time.perf_counter() - t0
        if isinstance(item, _Failed):
            raise RuntimeError("a PipelinedLoader worker failed") from item.exc
        return item

    def close(self):
        """Stop and JOIN the workers: after close() returns no worker is
        mid-``sample_fn``, so any state the sampler mutates (e.g. traffic
        counters) is quiescent and safe to read exactly."""
        self.stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        for w in self.workers:
            w.join()
