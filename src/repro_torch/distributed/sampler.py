"""Partition-aware distributed mini-batch sampling (the DistDGL/PaGraph
recipe, survey §3.2: partition → per-partition neighbor sampling → remote
feature fetch through a halo cache).

Each partition samples ONLY its owned seeds; the neighbor expansion itself
reuses the deterministic padded sampler built on
:func:`repro_torch.core.sampling.sample_block_padded` (shared with
serving, so a node's sampled neighborhood is a pure function of ``(seed,
layer, node)``).  That determinism is what makes the pipeline
*partition-invariant*: the union of all partitions' per-seed computation
trees equals the tree a single device would sample for the same seeds.

Remote features flow through :class:`PartitionFeatureStore`: rows the
partition owns are free local reads; rows owned elsewhere are
cross-partition traffic unless they sit in the halo cache (seeded by the
PaGraph ``degree_cache`` / AliGraph ``importance_cache`` policies,
restricted to the partition's ghost set from :mod:`repro_torch.core.halo`).

A rank of a distributed run builds only its own partition's store
(``parts=(rank,)``); the traffic of the whole run is the sum of the
ranks' :meth:`DistributedMinibatchSampler.counters`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import caching as CA
from repro_torch.core.abstraction import DeviceGraph
from repro_torch.core.caching import FeatureStore
from repro_torch.core.halo import HaloLayout, build_halo
from repro_torch.core.partitioning import (EdgeCutPartition,
                                           partition as make_partition)
from repro_torch.core.sampling import Block
from repro_torch.graph.structure import Graph
from repro_torch.serving.sampler import ServingSampler, needed_feature_mask

#: the traffic counters of a store, summed by :meth:`stats`
COUNTERS = ("hits", "misses", "cross_partition_bytes", "local_rows",
            "remote_requests")


class PartitionFeatureStore(FeatureStore):
    """A :class:`FeatureStore` as seen from one partition: owned rows are
    local reads (no traffic), remote rows go through the halo cache, and
    only cache-missing remote rows cross the interconnect — the quantity
    ``transferred_bytes`` counts (rows at the wire codec's per-row size +
    per-RPC header, via the shared :class:`repro_torch.core.comm.Transport`)."""

    def __init__(self, g: Graph, owned_ids: np.ndarray,
                 cache_ids: np.ndarray, *, codec="fp32",
                 path: str = "minibatch.features"):
        super().__init__(g, cache_ids, codec=codec, path=path)
        self.owned = np.zeros(g.num_nodes, bool)
        self.owned[owned_ids] = True
        self.local_rows = 0

    def _local_rows_mask(self, safe_ids: np.ndarray,
                         needed: np.ndarray) -> np.ndarray:
        local = needed & self.owned[safe_ids]
        self.local_rows += int(local.sum())
        return local


@dataclasses.dataclass
class PartitionBatch:
    """One partition's share of a global mini-batch, fixed shapes."""
    part: int
    seeds: np.ndarray            # (B_cap,) padded owned seeds (-1 empty)
    blocks: List[Block]          # innermost first, caps from block_shapes()
    x_in: np.ndarray             # (S0_cap, F) features of blocks[0].src_nodes
    labels: np.ndarray           # (B_cap,) int32 (garbage at pads)
    label_mask: np.ndarray       # (B_cap,) float32 — real owned seeds


class DistributedMinibatchSampler:
    """Splits global seed batches by partition ownership and samples each
    partition's padded mini-batch with the deterministic fixed-shape
    expansion, fetching input features through a partition-aware store.

    ``parts`` names the partitions whose stores are built (default: all,
    as the reference); sampling another partition raises ``KeyError``.
    """

    def __init__(self, g: Graph, n_parts: int, fanouts: Sequence[int],
                 batch_cap: int, *, partitioner: str = "hash",
                 cache_policy: str = "degree", cache_capacity: int = 0,
                 wire_codec: str = "fp32", seed: int = 0,
                 part: Optional[EdgeCutPartition] = None,
                 parts: Optional[Sequence[int]] = None):
        self.g = g
        if part is None:
            part = make_partition(g, n_parts, partitioner)
        if not isinstance(part, EdgeCutPartition):
            raise ValueError("distributed mini-batch training needs an "
                             "edge-cut partitioner (hash/ldg/fennel)")
        self.part = part
        self.n_parts = part.n_parts
        self.layout: HaloLayout = build_halo(g, part)
        self.sampler = ServingSampler(g, fanouts, seed=seed)
        self.fanouts = list(fanouts)
        self.batch_cap = batch_cap
        # GCN-style normalization uses the GLOBAL degree (precomputed
        # D^-1/2 as in DGL), not the in-block src degree: the block src
        # degree depends on which other seeds share the batch, which would
        # break partition-invariance
        self.out_deg = np.maximum(g.out_degree(), 1).astype(np.float32)
        # the policy ranking is partition-independent: compute it once and
        # restrict per partition to its ghost set
        if cache_policy == "none" or cache_capacity <= 0:
            order = np.zeros(0, np.int64)
        else:
            order = CA.CACHE_POLICIES[cache_policy](g, g.num_nodes)
        parts = range(self.n_parts) if parts is None else parts
        self.stores = {
            p: PartitionFeatureStore(
                g, self.layout.owned[p],
                self._halo_cache_ids(p, order, cache_capacity),
                codec=wire_codec)
            for p in parts}

    def _halo_cache_ids(self, p: int, order: np.ndarray,
                        capacity: int) -> np.ndarray:
        """Top-``capacity`` ghost vertices of partition ``p`` under the
        policy ranking (PaGraph degree / AliGraph importance)."""
        if not len(order):
            return np.zeros(0, np.int64)
        ghost = np.zeros(self.g.num_nodes, bool)
        ghost[self.layout.halo[p]] = True
        return order[ghost[order]][:capacity]

    # -- delta awareness ---------------------------------------------------
    def apply_delta(self, touched: np.ndarray) -> int:
        """React to an in-place graph fold whose frontier is ``touched``:
        recompute the global-degree normalization (edge deltas change
        degrees, and the GCN step reads ``out_deg``) and forward to the
        underlying :meth:`ServingSampler.apply_delta` so only touched
        nodes are re-expanded.  The partition assignment, halo layout and
        per-partition feature stores are deliberately RETAINED: ownership
        is keyed by node id (unchanged by edge deltas), feature stores
        read ``g.features`` live so feature updates propagate
        automatically, and the halo-cache admitted set is an accounting
        hint, not a correctness surface.  Returns dropped memo entries."""
        self.out_deg = np.maximum(self.g.out_degree(), 1).astype(np.float32)
        return self.sampler.apply_delta(touched)

    # -- shape contract ----------------------------------------------------
    def block_shapes(self):
        """(dst_cap, src_cap, edge_cap) per layer, innermost first —
        identical for every partition and every batch."""
        return self.sampler.block_shapes(self.batch_cap)

    # -- sampling ----------------------------------------------------------
    def owned_seeds(self, p: int, seeds: np.ndarray) -> np.ndarray:
        """The seeds of a global batch that partition ``p`` owns, in the
        batch's order."""
        seeds = np.asarray(seeds, np.int64)
        return seeds[self.layout.owner[seeds] == p]

    def sample_partition(self, p: int, seeds_p: np.ndarray) -> PartitionBatch:
        seeds_p = np.asarray(seeds_p, np.int64)
        if len(seeds_p) > self.batch_cap:
            raise ValueError(f"partition {p} got {len(seeds_p)} seeds "
                             f"> batch_cap {self.batch_cap}")
        padded = np.full((self.batch_cap,), -1, np.int64)
        padded[:len(seeds_p)] = seeds_p
        mb = self.sampler.sample(padded)
        # fetch only rows reachable from REAL seeds; pad-path slots get
        # zero rows and are never counted as traffic
        need = needed_feature_mask(mb.blocks, padded >= 0)
        x_in = self.stores[p].fetch_masked(mb.blocks[0].src_nodes, need)
        safe = np.maximum(padded, 0)
        labels = (self.g.labels[safe].astype(np.int32)
                  if self.g.labels is not None
                  else np.zeros(self.batch_cap, np.int32))
        mask = (padded >= 0).astype(np.float32)
        return PartitionBatch(p, padded, mb.blocks, x_in, labels, mask)

    def sample_global(self, seeds: np.ndarray) -> List[PartitionBatch]:
        """Split a global seed batch by ownership; every partition emits a
        fixed-shape batch (possibly all-padding)."""
        return [self.sample_partition(p, self.owned_seeds(p, seeds))
                for p in range(self.n_parts)]

    # -- traffic accounting ------------------------------------------------
    def counters(self) -> dict:
        """The built stores' traffic counters (``COUNTERS``), summed: the
        integers :meth:`stats` derives its ratios from, which the ranks of
        a distributed run add up."""
        s = list(self.stores.values())
        return {"hits": sum(x.hits for x in s),
                "misses": sum(x.misses for x in s),
                "cross_partition_bytes": sum(x.transferred_bytes for x in s),
                "local_rows": sum(x.local_rows for x in s),
                "remote_requests": sum(x.requests for x in s)}

    def stats(self, counters: Optional[dict] = None) -> dict:
        """The reference's traffic summary, from :meth:`counters` or from
        ``counters`` given (the ranks' sum)."""
        c = self.counters() if counters is None else counters
        looked = c["hits"] + c["misses"]
        return {
            "halo_hit_ratio": c["hits"] / looked if looked else 0.0,
            "cross_partition_bytes": c["cross_partition_bytes"],
            "local_rows": c["local_rows"],
            "remote_requests": c["remote_requests"],
            "ghost_fraction": self.layout.ghost_fraction(),
            "wire_codec": next(iter(self.stores.values())).codec.name,
        }


def device_blocks(batch: PartitionBatch, out_deg: np.ndarray,
                  device: Union[str, torch.device]) -> List[DeviceGraph]:
    """``batch``'s blocks on ``device`` with both grouped layouts, each
    block's ``out_deg`` replaced by the GLOBAL out-degree of its sources
    (see :class:`DistributedMinibatchSampler`): GCN's normalization then
    does not depend on which seeds share a batch."""
    out = []
    for b in batch.blocks:
        dg = DeviceGraph.from_block(b, device, src_layout=True)
        sdeg = out_deg[np.maximum(b.src_nodes, 0)].astype(np.float32)
        out.append(dataclasses.replace(
            dg, out_deg=torch.from_numpy(sdeg).to(dg.edge_src.device)))
    return out
