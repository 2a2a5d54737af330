"""Distributed mini-batch training pipeline: collate → prefetch → one
rank's step.

Three pieces (survey §3.2.5–§3.2.8 applied to the mini-batch path):

* :func:`collate` stacks each partition's fixed-shape
  :class:`~repro_torch.distributed.sampler.PartitionBatch` into arrays
  with a leading partition axis (the reference's ``shard_map`` inputs;
  the port's ranks each take their own batch, and the tests compare the
  stacks).
* :class:`HostPrefetcher` double-buffers host-side work: while the step
  consumes batch *t* on the device, a worker thread samples and
  feature-fetches batch *t+1* (DistDGL's sampler processes / AGL's
  pipelined stages).  Built on
  :class:`repro_torch.core.scheduling.PipelinedLoader`; the asynchronous
  full-graph trainer plans on it too.
* :func:`make_distributed_minibatch_step` builds one rank's step: the
  block forward over its partition's batch, the loss divided by the
  GLOBAL seed count, and the gradients and the loss summed over the ranks
  in one rank-order all-reduce before a replicated optimizer update —
  the single-device mean over the same global seed set.
"""
from __future__ import annotations

import time
from typing import Callable, List

import numpy as np
import torch

from repro_torch.core import propagation as PR
from repro_torch.core import telemetry
from repro_torch.core.comm import resolve_codec
from repro_torch.core.scheduling import PipelinedLoader
from repro_torch.distributed.sampler import PartitionBatch, device_blocks
from repro_torch.models.gnn import model as GM
from repro_torch.models.gnn.model import GNNConfig


# ---------------------------------------------------------------------------
# collation: per-partition batches -> partition-major arrays
# ---------------------------------------------------------------------------

def collate(batches: List[PartitionBatch], out_deg: np.ndarray) -> dict:
    """Stack P fixed-shape partition batches (the reference's
    ``shard_map`` inputs).

    Returns per-layer tuples (leading dim P):
      es/ed/em: (P, E_l) edge indices + mask;  sdeg: (P, S_l) global src
      out-degree (GCN normalization);  x: (P, S0, F);  y/w: (P, B).
    """
    L = len(batches[0].blocks)
    es = tuple(np.stack([b.blocks[l].edge_src for b in batches])
               .astype(np.int32) for l in range(L))
    ed = tuple(np.stack([b.blocks[l].edge_dst for b in batches])
               .astype(np.int32) for l in range(L))
    em = tuple(np.stack([b.blocks[l].edge_mask for b in batches])
               for l in range(L))
    sdeg = tuple(np.stack(
        [out_deg[np.maximum(b.blocks[l].src_nodes, 0)] for b in batches])
        .astype(np.float32) for l in range(L))
    return {
        "es": es, "ed": ed, "em": em, "sdeg": sdeg,
        "x": np.stack([b.x_in for b in batches]),
        "y": np.stack([b.labels for b in batches]).astype(np.int32),
        "w": np.stack([b.label_mask for b in batches]).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# double-buffered host-side prefetch
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# one rank's step
# ---------------------------------------------------------------------------

def make_distributed_minibatch_step(cfg: GNNConfig, optimizer):
    """One rank's partition-parallel mini-batch step.

    ``train_step(params, batch, out_deg, count) -> loss``: ``batch`` is
    this rank's :class:`PartitionBatch`, ``out_deg`` the sampler's global
    out-degrees (:func:`device_blocks`), ``count`` the number of real
    seeds in the GLOBAL batch.  Every rank draws the same global batch,
    so every rank knows ``count`` on the host: the reference's
    ``psum(sum(w))``, the same integer, without a collective, and outside
    the differentiated function (inside it, the reference's psum would
    transpose to a second one).  The rank's blocks are built on the
    parameters' device, its NLL sum divided by ``count``, and after
    ``backward()`` the gradients and the loss are summed over the ranks
    (``propagation.sum_grads_and_loss``) before ``optimizer`` (built on
    ``params``, replicated) steps; the summed loss is returned as a 0-d
    tensor.  Every rank's parameters stay bitwise equal.

    ``cfg.wire_codec`` names the codec the feature path used: the rows in
    ``batch.x_in`` arrive codec-decoded from the rank's
    ``PartitionFeatureStore``, as the reference's ``collate`` gives them,
    so the step consumes them as they are; the name is resolved here only
    to fail fast on a typo before the first batch is sampled.
    """
    resolve_codec(cfg.wire_codec)

    def train_step(params, batch: PartitionBatch, out_deg: np.ndarray,
                   count: int) -> torch.Tensor:
        device = next(params.parameters()).device
        blocks = device_blocks(batch, out_deg, device)
        x = torch.from_numpy(batch.x_in).to(device)
        y = torch.from_numpy(batch.labels).to(device)
        w = torch.from_numpy(batch.label_mask).to(device)
        optimizer.zero_grad(set_to_none=True)
        total, _ = GM.nll_sum_count(GM.forward_blocks(cfg, params, blocks,
                                                      x), y, w)
        loss = total / float(max(count, 1))
        loss.backward()
        summed = PR.sum_grads_and_loss(params, loss)
        optimizer.step()
        return summed

    return train_step
