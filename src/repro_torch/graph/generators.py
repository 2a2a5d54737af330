"""Synthetic graph generators (deterministic, numpy-only, fast at 1e5+ nodes).

These supply the survey-claim experiments: power-law graphs for the
vertex-cut/replication-factor claims (PowerGraph/PowerLyra), community
graphs for ClusterGCN-style sampling, grids for 2D partitioning.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.structure import Graph, from_edges, make_undirected


def erdos_renyi(n: int, avg_degree: float, *, seed: int = 0,
                directed: bool = True) -> Graph:
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != dst
    e = np.stack([src[keep], dst[keep]], axis=1)
    if directed:
        return from_edges(n, e)
    return make_undirected(n, e)


def barabasi_albert(n: int, m: int, *, seed: int = 0) -> Graph:
    """Power-law (preferential attachment) graph — 'natural graph' with
    skewed degree distribution (PowerGraph's motivating case)."""
    rng = np.random.default_rng(seed)
    targets = list(range(m))
    repeated: list = list(range(m))
    edges = []
    for v in range(m, n):
        # preferential attachment: sample from the degree-weighted pool
        idx = rng.integers(0, len(repeated), m)
        chosen = np.unique(np.asarray([repeated[i] for i in idx]))
        for t in chosen:
            edges.append((v, t))
        repeated.extend(chosen.tolist())
        repeated.extend([v] * len(chosen))
    return make_undirected(n, np.asarray(edges, np.int64))


def sbm(n: int, n_blocks: int, p_in: float, p_out: float, *,
        seed: int = 0) -> Graph:
    """Stochastic block model with planted communities; labels = block id."""
    rng = np.random.default_rng(seed)
    block = rng.integers(0, n_blocks, n)
    # expected edges: sample pairs then filter by block-dependent prob
    m = int(n * (p_in + p_out) * 40)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    same = block[src] == block[dst]
    prob = np.where(same, p_in, p_out)
    keep = (rng.random(m) < prob) & (src != dst)
    g = make_undirected(n, np.stack([src[keep], dst[keep]], 1))
    g.labels = block.astype(np.int32)
    g.num_classes = n_blocks
    return g


def grid2d(rows: int, cols: int) -> Graph:
    idx = np.arange(rows * cols).reshape(rows, cols)
    e = []
    e.append(np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1))
    e.append(np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1))
    return make_undirected(rows * cols, np.concatenate(e, 0))


def featurize(g: Graph, feat_dim: int, *, seed: int = 0,
              num_classes: int = 0, class_sep: float = 2.0) -> Graph:
    """Attach Gaussian class-clustered features (and labels if absent) so
    node classification is learnable — the synthetic stand-in for
    CORA/Reddit-style datasets (survey Table 9)."""
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    if g.labels is None:
        if num_classes <= 0:
            num_classes = 8
        g.labels = rng.integers(0, num_classes, n).astype(np.int32)
        g.num_classes = num_classes
    k = g.num_classes
    centers = rng.normal(0, class_sep, (k, feat_dim))
    g.features = (centers[g.labels]
                  + rng.normal(0, 1.0, (n, feat_dim))).astype(np.float32)
    return g
