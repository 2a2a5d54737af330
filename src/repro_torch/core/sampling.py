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
