"""Request objects and admission queue for the GNN inference server.

Arrival times are *virtual* seconds: workloads are generated with explicit
arrival stamps and the server advances a virtual clock by the measured
compute time of each batch, so latency distributions are reproducible and
the simulation never sleeps.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Deque, List, Optional

import numpy as np


def advance_vclock(vnow: float, nxt: float) -> float:
    """Advance a virtual clock toward the next event with STRICT progress.

    Returns ``nxt`` when it lies strictly ahead of ``vnow``; otherwise
    marches ``vnow`` one ulp forward.  The one-ulp step is load-bearing:
    landing exactly on ``fl(oldest + max_wait)`` can leave the recomputed
    head-of-line wait ``vnow - oldest`` one rounding error SHORT of
    ``max_wait_s``, so the batcher keeps refusing to emit and a plain
    ``max(vnow, nxt)`` pins the clock forever at 100% CPU — the PR 8
    livelock.  Marching one ulp flips the comparison within a few
    iterations.  Every serve/fleet loop must advance its clock through
    this helper (statically enforced by lint rule RL003,
    ``python -m repro_torch.analysis``).
    """
    return nxt if nxt > vnow else math.nextafter(vnow, math.inf)


@dataclasses.dataclass
class InferenceRequest:
    """One per-node prediction request.  ``params_version`` is stamped at
    completion with the single weight version that computed the response
    (-1 = not yet served) — the end-to-end consistency tag the rolling
    hot-swap tests assert on."""
    req_id: int
    node_id: int
    arrival_s: float
    done_s: float = -1.0
    logits: Optional[np.ndarray] = None
    params_version: int = -1

    @property
    def latency_s(self) -> float:
        return self.done_s - self.arrival_s if self.done_s >= 0 else -1.0


class RequestQueue:
    """FIFO admission queue (oldest first — the batcher's wait policy keys
    off the head-of-line request)."""

    def __init__(self):
        self._q: Deque[InferenceRequest] = collections.deque()

    def push(self, req: InferenceRequest) -> None:
        self._q.append(req)

    def pop_up_to(self, n: int) -> List[InferenceRequest]:
        out = []
        while self._q and len(out) < n:
            out.append(self._q.popleft())
        return out

    def oldest_arrival(self) -> Optional[float]:
        return self._q[0].arrival_s if self._q else None

    def __len__(self) -> int:
        return len(self._q)


def poisson_workload(num_requests: int, node_ids: np.ndarray, rate_rps: float,
                     *, seed: int = 0, zipf_a: float = 1.5) -> List[InferenceRequest]:
    """Poisson arrivals over a Zipf-skewed node popularity distribution —
    the 'heavy traffic from millions of users' regime where a small hot
    set of vertices absorbs most requests (what makes caching pay)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(rate_rps, 1e-9), num_requests)
    arrivals = np.cumsum(gaps)
    # bounded Zipf over exactly len(node_ids) ranks (clipping rng.zipf's
    # unbounded tail would pile its mass onto one arbitrary node)
    p = np.arange(1, len(node_ids) + 1, dtype=np.float64) ** -zipf_a
    ranks = rng.choice(len(node_ids), num_requests, p=p / p.sum())
    # map popularity rank -> node id via a fixed permutation
    perm = rng.permutation(len(node_ids))
    nodes = np.asarray(node_ids)[perm[ranks]]
    return [InferenceRequest(i, int(nodes[i]), float(arrivals[i]))
            for i in range(num_requests)]
