"""Dynamic micro-batcher with a fixed bucket-shape vocabulary.

TPU/XLA discipline (same as ``core/sampling``): every batch must be one of
a small declared set of padded sizes so each (bucket, arch) pair compiles
exactly once and every later batch hits that jit cache entry.  The batcher
trades a little padding waste for zero recompilation — the classic serving
bucketing policy (e.g. TF-Serving / NVIDIA Triton shape buckets).

Emission policy:
* emit as soon as a full largest-bucket batch is pending (throughput), or
* when the head-of-line request has waited ``max_wait_s`` (latency), or
* when ``force`` is set (drain at end of workload).
The bucket chosen is the smallest declared size that fits the pending
requests (capped at the largest bucket).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.serving.request import InferenceRequest, RequestQueue

PAD_ID = -1


@dataclasses.dataclass
class MicroBatch:
    """One padded inference batch: ``node_ids`` is ``(bucket,)`` with
    UNIQUE real ids as a prefix and ``PAD_ID`` (-1) pads; ``slots[j]``
    maps request ``j`` to its id slot (duplicate requests for one node
    share a slot).  Pad slots never sample, fetch, or aggregate — they
    only keep the shape static."""
    requests: List[InferenceRequest]
    node_ids: np.ndarray        # (bucket,) int64, UNIQUE ids, PAD_ID pads
    bucket: int
    formed_s: float
    # slot index into node_ids per request — duplicate requests for the
    # same node share one slot (dedup batching)
    slots: List[int] = dataclasses.field(default_factory=list)

    @property
    def pad_mask(self) -> np.ndarray:
        return self.node_ids >= 0

    @property
    def fill(self) -> float:
        return int(self.pad_mask.sum()) / self.bucket


class BucketedBatcher:
    """Dynamic micro-batcher over a declared bucket-size vocabulary.

    Args:
        buckets: allowed padded batch sizes (sorted, deduped); every
            emitted :class:`MicroBatch` has ``bucket ∈ buckets``, so the
            downstream jit cache holds at most ``len(buckets)`` entries
            per arch.
        max_wait_s: head-of-line latency bound — a queued request never
            waits longer than this for a batch to form (the serve loop's
            virtual clock honors it as an event deadline).

    ``form`` returns ``None`` when no emission rule fires; ``pad_overhead``
    reports the fraction of emitted slots that were padding.
    """

    def __init__(self, buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64),
                 *, max_wait_s: float = 0.002):
        if not buckets:
            raise ValueError("need at least one bucket size")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.max_wait_s = max_wait_s
        self.emitted = 0
        self.padded_slots = 0
        self.real_slots = 0

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest declared bucket that holds ``n`` (capped at largest)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.max_bucket

    def should_emit(self, queue: RequestQueue, now: float,
                    force: bool = False) -> bool:
        if len(queue) == 0:
            return False
        if force or len(queue) >= self.max_bucket:
            return True
        oldest = queue.oldest_arrival()
        return oldest is not None and (now - oldest) >= self.max_wait_s

    def form(self, queue: RequestQueue, now: float,
             force: bool = False) -> Optional[MicroBatch]:
        if not self.should_emit(queue, now, force):
            return None
        reqs = queue.pop_up_to(self.max_bucket)
        # dedup: requests for the same node share one slot (the sampler
        # requires unique dst ids, and one prediction serves them all)
        slot_of = {}
        for r in reqs:
            slot_of.setdefault(r.node_id, len(slot_of))
        bucket = self.bucket_for(len(slot_of))
        ids = np.full((bucket,), PAD_ID, np.int64)
        for nid, slot in slot_of.items():
            ids[slot] = nid
        self.emitted += 1
        self.real_slots += len(slot_of)
        self.padded_slots += bucket - len(slot_of)
        return MicroBatch(reqs, ids, bucket, now,
                          slots=[slot_of[r.node_id] for r in reqs])

    @property
    def pad_overhead(self) -> float:
        tot = self.real_slots + self.padded_slots
        return self.padded_slots / tot if tot else 0.0
