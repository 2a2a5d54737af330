"""Sampling strategies for mini-batch GNN training (survey §3.2.2, Table 4).

All samplers are host-side (numpy) and deterministic under a seed, mirroring
the surveyed systems where sampling workers run on CPU (DistDGL, AGL).
They emit fixed-shape, padded :class:`Block`s so every mini-batch hits the
same jit cache entry (a TPU adaptation: the surveyed GPU systems use ragged
buffers; XLA wants static shapes — recorded in DESIGN.md).

A k-layer mini-batch is a list of ``Block``s, innermost first:
block[i] maps features over layer i: dst nodes aggregate from src nodes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from repro_torch.graph.structure import Graph


@dataclasses.dataclass
class Block:
    """Bipartite computation block (DGL 'nodeflow' style), padded.

    src_nodes: (S,) global ids of source nodes (padded with -1)
    dst_nodes: (D,) global ids of destination nodes (padded with -1)
    edge_src:  (E,) local src index per edge (padded 0)
    edge_dst:  (E,) local dst index per edge (padded 0)
    edge_mask: (E,) validity
    NOTE: dst nodes are ALWAYS a prefix of src nodes (self features flow).
    """
    src_nodes: np.ndarray
    dst_nodes: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_mask: np.ndarray

    @property
    def num_src(self) -> int:
        return len(self.src_nodes)

    @property
    def num_dst(self) -> int:
        return len(self.dst_nodes)


@dataclasses.dataclass
class MiniBatch:
    blocks: List[Block]          # innermost (layer-0) first
    seeds: np.ndarray            # (B,) target nodes (== blocks[-1].dst_nodes)
    input_nodes: np.ndarray      # == blocks[0].src_nodes


def _pad_to(a: np.ndarray, n: int, fill) -> np.ndarray:
    out = np.full((n,), fill, a.dtype)
    out[:len(a)] = a[:n]
    return out


def _build_block(g: Graph, dst: np.ndarray, src_extra: np.ndarray,
                 edges: np.ndarray, src_cap: int, edge_cap: int) -> Block:
    """edges: (E,2) [src_global, dst_global]; src = dst ∪ extra (dst prefix)."""
    src = np.concatenate([dst, np.setdiff1d(src_extra, dst)])
    src = src[:src_cap]
    lookup_src = {v: i for i, v in enumerate(src)}
    lookup_dst = {v: i for i, v in enumerate(dst)}
    es, ed, keep = [], [], []
    for s, d in edges:
        si = lookup_src.get(s)
        di = lookup_dst.get(d)
        if si is not None and di is not None:
            es.append(si)
            ed.append(di)
    es = np.asarray(es[:edge_cap], np.int32)
    ed = np.asarray(ed[:edge_cap], np.int32)
    mask = np.zeros(edge_cap, bool)
    mask[:len(es)] = True
    return Block(
        src_nodes=_pad_to(src.astype(np.int64), src_cap, -1),
        dst_nodes=dst.astype(np.int64),
        edge_src=_pad_to(es, edge_cap, 0),
        edge_dst=_pad_to(ed, edge_cap, 0),
        edge_mask=mask,
    )


def sample_block_padded(g: Graph, gr: Graph, dst: np.ndarray, fanout: int,
                        rng_for, *, expand: np.ndarray = None,
                        picker=None) -> Block:
    """One fixed-shape layer expansion (the serving-path primitive).

    Unlike the training samplers above, ``dst`` here is a PADDED id array
    (-1 marks an empty slot) and the emitted block's shapes depend only on
    ``(len(dst), fanout)``: src_cap = D*(1+fanout), edge_cap = D*fanout.
    Every batch drawn from the same bucket therefore hits the same jit
    cache entry.

    ``rng_for(node)`` must return a Generator for that node so a node's
    sampled neighborhood is stable across requests (cache consistency).
    ``expand`` (bool, aligned with ``dst``) restricts which dst nodes get
    edges — serving skips expansion for embedding-cache hits.
    ``picker(node, nbr)``, when given, replaces the per-node rng pick
    entirely (the delta-aware samplers memoize picks through it; any
    picker must stay a pure function of ``(node, nbr)`` to preserve the
    determinism contract).
    """
    dst = np.asarray(dst, np.int64)
    dcap = len(dst)
    valid = dst >= 0
    real = dst[valid]
    if len(np.unique(real)) != len(real):
        # _build_block's slot lookup maps each id to ONE slot; duplicate
        # dst ids would leave the other slots silently edge-less
        raise ValueError("padded dst ids must be unique (dedup upstream)")
    if expand is not None:
        valid = valid & expand
    edges, srcs = [], []
    for d in dst[valid]:
        nbr = gr.neighbors(int(d))
        if len(nbr) == 0:
            continue
        if picker is not None:
            pick = picker(int(d), nbr)
        else:
            rng = rng_for(int(d))
            pick = nbr if len(nbr) <= fanout else rng.choice(
                nbr, fanout, replace=False)
        for s in pick:
            edges.append((int(s), int(d)))
        srcs.append(np.asarray(pick, np.int64))
    src_extra = (np.unique(np.concatenate(srcs))
                 if srcs else np.zeros(0, np.int64))
    return _build_block(
        g, dst, src_extra,
        np.asarray(edges, np.int64).reshape(-1, 2),
        dcap * (1 + fanout), dcap * fanout)


# ===========================================================================
# neighbor sampling (GraphSAGE)
# ===========================================================================

class NeighborSampler:
    """Fixed-fanout neighbor sampling [GraphSAGE, Hamilton+ 2017].

    For each layer (outermost last) sample ``fanout`` in-neighbors per dst
    node (with replacement if deg < fanout; missing → dropped via mask).

    One ``np.random.Generator`` serves every call: two loader threads
    sampling at once interleave its draws, so a run is repeatable only
    with one sampling thread."""

    name = "neighbor"

    def __init__(self, g: Graph, fanouts: Sequence[int], *, seed: int = 0):
        self.g = g
        self.gr = g.reverse()      # need in-neighbors
        self.fanouts = list(fanouts)
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray) -> MiniBatch:
        seeds = np.asarray(seeds, np.int64)
        blocks: List[Block] = []
        dst = seeds
        for layer in reversed(range(len(self.fanouts))):
            f = self.fanouts[layer]
            srcs, edges = [], []
            for d in dst:
                nbr = self.gr.neighbors(d)   # in-neighbors of d
                if len(nbr) == 0:
                    continue
                pick = nbr if len(nbr) <= f else self.rng.choice(
                    nbr, f, replace=False)
                for s in pick:
                    edges.append((s, d))
                srcs.append(pick)
            src_extra = (np.unique(np.concatenate(srcs))
                         if srcs else np.zeros(0, np.int64))
            src_cap = len(dst) + len(dst) * f
            blocks.append(_build_block(
                self.g, dst, src_extra,
                np.asarray(edges, np.int64).reshape(-1, 2),
                src_cap, len(dst) * f))
            dst = blocks[-1].src_nodes[blocks[-1].src_nodes >= 0]
        blocks.reverse()
        return MiniBatch(blocks, seeds, blocks[0].src_nodes)


# ===========================================================================
# importance / layer-wise sampling (PinSage / FastGCN / LADIES)
# ===========================================================================

class ImportanceSampler(NeighborSampler):
    """PinSage-style: score neighbors by short-random-walk visit counts and
    keep the top-``fanout`` instead of a uniform pick."""

    name = "importance"

    def __init__(self, g: Graph, fanouts, *, walk_len: int = 2,
                 n_walks: int = 8, seed: int = 0):
        super().__init__(g, fanouts, seed=seed)
        self.walk_len = walk_len
        self.n_walks = n_walks

    def _walk_scores(self, d: int) -> tuple:
        counts: dict = {}
        for _ in range(self.n_walks):
            v = d
            for _ in range(self.walk_len):
                nbr = self.gr.neighbors(v)
                if len(nbr) == 0:
                    break
                v = int(self.rng.choice(nbr))
                counts[v] = counts.get(v, 0) + 1
        return counts

    def sample(self, seeds: np.ndarray) -> MiniBatch:
        seeds = np.asarray(seeds, np.int64)
        blocks: List[Block] = []
        dst = seeds
        for layer in reversed(range(len(self.fanouts))):
            f = self.fanouts[layer]
            edges = []
            for d in dst:
                scores = self._walk_scores(int(d))
                top = sorted(scores, key=scores.get, reverse=True)[:f]
                for s in top:
                    edges.append((s, d))
            e = np.asarray(edges, np.int64).reshape(-1, 2)
            src_extra = np.unique(e[:, 0]) if len(e) else np.zeros(0, np.int64)
            blocks.append(_build_block(self.g, dst, src_extra, e,
                                       len(dst) * (1 + f), len(dst) * f))
            dst = blocks[-1].src_nodes[blocks[-1].src_nodes >= 0]
        blocks.reverse()
        return MiniBatch(blocks, seeds, blocks[0].src_nodes)


class LayerWiseSampler:
    """FastGCN [Chen+ 2018] (``dependent=False``) and LADIES [Zou+ 2019]
    (``dependent=True``): sample a fixed node budget per layer with
    probability ∝ (in-)degree; LADIES restricts candidates to the union of
    neighbors of the previous layer (layer-dependent)."""

    def __init__(self, g: Graph, layer_sizes: Sequence[int], *,
                 dependent: bool = True, seed: int = 0):
        self.g = g
        self.gr = g.reverse()
        self.layer_sizes = list(layer_sizes)
        self.dependent = dependent
        self.rng = np.random.default_rng(seed)
        deg = g.in_degree().astype(np.float64) + 1.0
        self.prob = deg / deg.sum()
        self.name = "ladies" if dependent else "fastgcn"

    def sample(self, seeds: np.ndarray) -> MiniBatch:
        seeds = np.asarray(seeds, np.int64)
        blocks: List[Block] = []
        dst = seeds
        for layer in reversed(range(len(self.layer_sizes))):
            budget = self.layer_sizes[layer]
            if self.dependent:
                cand = np.unique(np.concatenate(
                    [self.gr.neighbors(d) for d in dst]
                    + [np.zeros(0, np.int64)]))
            else:
                cand = np.arange(self.g.num_nodes)
            if len(cand) == 0:
                cand = dst
            p = self.prob[cand]
            p = p / p.sum()
            n_pick = min(budget, len(cand))
            picked = self.rng.choice(cand, n_pick, replace=False, p=p)
            # connect: edges from picked -> dst that exist in g
            edges = []
            pick_set = set(picked.tolist())
            for d in dst:
                for s in self.gr.neighbors(d):
                    if int(s) in pick_set:
                        edges.append((int(s), int(d)))
            e = np.asarray(edges, np.int64).reshape(-1, 2)
            blocks.append(_build_block(
                self.g, dst, picked, e, len(dst) + budget,
                max(len(e), 1)))
            dst = blocks[-1].src_nodes[blocks[-1].src_nodes >= 0]
        blocks.reverse()
        return MiniBatch(blocks, seeds, blocks[0].src_nodes)


# ===========================================================================
# subgraph sampling (ClusterGCN / GraphSAINT)
# ===========================================================================

def bfs_clusters(g: Graph, n_clusters: int, *, seed: int = 0) -> np.ndarray:
    """Cheap METIS stand-in: multi-source BFS growth from random centers
    (balanced-ish, locality-preserving).  Returns (N,) cluster ids."""
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    centers = rng.choice(n, n_clusters, replace=False)
    assign = -np.ones(n, np.int64)
    frontier = [[c] for c in centers]
    assign[centers] = np.arange(n_clusters)
    active = True
    while active:
        active = False
        for cid in range(n_clusters):
            nxt = []
            for v in frontier[cid]:
                for u in g.neighbors(v):
                    if assign[u] < 0:
                        assign[u] = cid
                        nxt.append(int(u))
            frontier[cid] = nxt
            active = active or bool(nxt)
    unassigned = np.flatnonzero(assign < 0)
    assign[unassigned] = rng.integers(0, n_clusters, len(unassigned))
    return assign


class ClusterSampler:
    """ClusterGCN [Chiang+ 2019]: mini-batch = union of q random clusters;
    training runs on the induced subgraph."""

    name = "cluster"

    def __init__(self, g: Graph, n_clusters: int, clusters_per_batch: int,
                 *, seed: int = 0):
        self.g = g
        self.assign = bfs_clusters(g, n_clusters, seed=seed)
        self.q = clusters_per_batch
        self.n_clusters = n_clusters
        self.rng = np.random.default_rng(seed + 1)

    def sample_subgraph(self):
        cids = self.rng.choice(self.n_clusters, self.q, replace=False)
        nodes = np.flatnonzero(np.isin(self.assign, cids))
        return nodes, self.g.subgraph(nodes)


class SaintRWSampler:
    """GraphSAINT [Zeng+ 2019] random-walk sampler: roots + fixed-length
    walks induce the subgraph; builds a full GCN per subgraph."""

    name = "saint_rw"

    def __init__(self, g: Graph, n_roots: int, walk_len: int, *,
                 seed: int = 0):
        self.g = g
        self.n_roots = n_roots
        self.walk_len = walk_len
        self.rng = np.random.default_rng(seed)

    def sample_subgraph(self):
        roots = self.rng.choice(self.g.num_nodes, self.n_roots, replace=False)
        nodes = set(roots.tolist())
        for r in roots:
            v = int(r)
            for _ in range(self.walk_len):
                nbr = self.g.neighbors(v)
                if len(nbr) == 0:
                    break
                v = int(self.rng.choice(nbr))
                nodes.add(v)
        nodes = np.asarray(sorted(nodes), np.int64)
        return nodes, self.g.subgraph(nodes)


def neighborhood_growth(g: Graph, seeds: np.ndarray, hops: int) -> List[int]:
    """|k-hop neighborhood| per hop — quantifies the 'neighborhood
    explosion' the survey motivates sampling with (§3.2.2)."""
    cur = set(np.asarray(seeds).tolist())
    sizes = [len(cur)]
    gr = g.reverse()
    for _ in range(hops):
        nxt = set(cur)
        for v in cur:
            nxt.update(gr.neighbors(v).tolist())
        cur = nxt
        sizes.append(len(cur))
    return sizes
