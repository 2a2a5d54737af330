"""Double-buffered host-side prefetch for the distributed trainers.

Of the reference's module only :class:`HostPrefetcher` is ported, which
the asynchronous full-graph trainer plans on; ``collate`` and the
partition-parallel mini-batch step come with the distributed mini-batch
pipeline (ROADMAP.md queue 1, item 9 (iii)).
"""
from __future__ import annotations

import time
from typing import Callable

from repro_torch.core import telemetry
from repro_torch.core.scheduling import PipelinedLoader


class HostPrefetcher:
    """Double-buffered loader: one batch ready in the queue, one being
    produced by the worker thread, one being consumed by the device step —
    host work for item *t+1* overlaps the step on item *t*.
    ``wait_s``/``sample_s`` quantify how much host time the overlap
    actually hid."""

    def __init__(self, make_batch: Callable[[], object], *, depth: int = 2):
        self.sample_s = 0.0
        self.produced = 0
        self._m_stall = telemetry.counter(
            "prefetch_stall_seconds_total",
            "consumer seconds blocked on the prefetch queue (un-hidden "
            "host-side sampling time)")
        self._stall_seen = 0.0

        def timed():
            t0 = time.perf_counter()
            item = make_batch()
            self.sample_s += time.perf_counter() - t0
            self.produced += 1
            return item

        self.loader = PipelinedLoader(timed, depth=max(1, depth - 1),
                                      n_workers=1)

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self.loader)
        # telemetry counters are monotone: feed them the *delta* of the
        # loader's cumulative idle clock since the last item
        stall = self.loader.idle_s
        self._m_stall.inc(max(0.0, stall - self._stall_seen))
        self._stall_seen = stall
        return item

    @property
    def wait_s(self) -> float:
        """Consumer time spent blocked on the queue (un-hidden work)."""
        return self.loader.idle_s

    def overlap_ratio(self) -> float:
        """Fraction of host production time hidden behind device compute."""
        if self.sample_s <= 0:
            return 0.0
        return max(0.0, 1.0 - self.wait_s / self.sample_s)

    def close(self):
        self.loader.close()
