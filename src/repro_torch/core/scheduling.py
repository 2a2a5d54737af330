"""Scheduling strategies (survey §3.2.8, Table 8).

* :class:`PipelinedLoader` — AGL-style: the sampling/preprocessing stage
  runs in worker threads in parallel with model computation; after a few
  iterations training time ≈ model-compute time.
* :class:`WorkStealingPool` — GraphTheta-style work stealing over sampling
  tasks (threads steal from a shared deque).
* :func:`cost_balanced_assignment` — FlexGraph-style: assign partitions to
  workers by predicted computation cost (:func:`predict_partition_cost`),
  minimizing the max-load plan.
"""
from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, List, Sequence

import numpy as np


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


class WorkStealingPool:
    """Static task assignment + stealing: each worker owns a deque; when
    empty it steals from the back of the longest remaining queue."""

    def __init__(self, tasks_per_worker: Sequence[List[Callable]]):
        self.deques = [collections.deque(t) for t in tasks_per_worker]
        self.lock = threading.Lock()
        self.stolen = 0
        self.done = 0

    def _take(self, wid: int):
        with self.lock:
            if self.deques[wid]:
                return self.deques[wid].popleft(), False
            victim = max(range(len(self.deques)),
                         key=lambda i: len(self.deques[i]))
            if self.deques[victim]:
                return self.deques[victim].pop(), True
        return None, False

    def run(self) -> dict:
        results = []

        def worker(wid):
            while True:
                task, was_stolen = self._take(wid)
                if task is None:
                    return
                r = task()
                with self.lock:
                    results.append(r)
                    self.done += 1
                    if was_stolen:
                        self.stolen += 1

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(self.deques))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return {"wall_s": time.perf_counter() - t0, "stolen": self.stolen,
                "done": self.done, "results": results}


def cost_balanced_assignment(part_costs: np.ndarray,
                             n_workers: int) -> np.ndarray:
    """FlexGraph-style LPT (longest-processing-time) assignment of partition
    costs to workers; returns worker id per partition."""
    order = np.argsort(-part_costs)
    load = np.zeros(n_workers)
    assign = np.zeros(len(part_costs), np.int32)
    for p in order:
        w = int(np.argmin(load))
        assign[p] = w
        load[w] += part_costs[p]
    return assign


def predict_partition_cost(num_vertices: np.ndarray, num_edges: np.ndarray,
                           feat_dim: int, hidden: int) -> np.ndarray:
    """FlexGraph's per-partition GNN cost model: vertex term (dense matmul)
    + edge term (aggregation traffic)."""
    return (num_vertices * feat_dim * hidden + num_edges * feat_dim
            ).astype(np.float64)
