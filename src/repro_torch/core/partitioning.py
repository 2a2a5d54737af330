"""Graph partitioning strategies (survey §3.2.1 / §2.2.2, Tables 1 & 3).

All partitioners are host-side (numpy) preprocessing, as in the surveyed
systems.  Edge-cut partitioners return a vertex→partition assignment;
vertex-cut partitioners return an edge→partition assignment (vertices are
replicated); the 2D grid partitioner returns per-edge block coordinates.

Quality metrics (§3.2.1): replication factor, edge-cut fraction, balance.

A copy of the reference's module: the same assignments, integer for
integer.  The grid partitioner raises ``ValueError`` on a P that is not a
square, where the reference asserts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.graph.structure import Graph


@dataclasses.dataclass
class EdgeCutPartition:
    assignment: np.ndarray       # (N,) vertex -> partition
    n_parts: int

    def edge_cut_fraction(self, g: Graph) -> float:
        e = g.edges()
        return float(np.mean(self.assignment[e[:, 0]]
                             != self.assignment[e[:, 1]]))

    def balance(self) -> float:
        sizes = np.bincount(self.assignment, minlength=self.n_parts)
        return float(sizes.max() / max(sizes.mean(), 1e-9))

    def replication_factor(self, g: Graph) -> float:
        """#(vertex, partition) pairs that must hold the vertex (owner +
        ghost copies for cut edges) / N."""
        e = g.edges()
        pairs = np.concatenate([
            np.stack([e[:, 0], self.assignment[e[:, 1]]], 1),
            np.stack([e[:, 1], self.assignment[e[:, 0]]], 1),
            np.stack([np.arange(g.num_nodes), self.assignment], 1),
        ])
        uniq = np.unique(pairs, axis=0)
        return float(len(uniq) / g.num_nodes)


@dataclasses.dataclass
class VertexCutPartition:
    edge_assignment: np.ndarray  # (E,) edge -> partition
    n_parts: int
    _edges: np.ndarray           # (E, 2)

    def replication_factor(self, g: Graph) -> float:
        pairs = np.concatenate([
            np.stack([self._edges[:, 0], self.edge_assignment], 1),
            np.stack([self._edges[:, 1], self.edge_assignment], 1)])
        uniq = np.unique(pairs, axis=0)
        return float(len(uniq) / g.num_nodes)

    def balance(self) -> float:
        sizes = np.bincount(self.edge_assignment, minlength=self.n_parts)
        return float(sizes.max() / max(sizes.mean(), 1e-9))


# ===========================================================================
# edge-cut family
# ===========================================================================

def hash_partition(g: Graph, n_parts: int) -> EdgeCutPartition:
    """Pregel/P3: partition(v) = hash(v) mod N — minimal preprocessing."""
    # splitmix-style integer hash for dispersion
    v = np.arange(g.num_nodes, dtype=np.uint64)
    v = (v ^ (v >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    v = (v ^ (v >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    v = v ^ (v >> np.uint64(31))
    return EdgeCutPartition((v % np.uint64(n_parts)).astype(np.int32),
                            n_parts)


def ldg_partition(g: Graph, n_parts: int, *, slack: float = 1.1,
                  seed: int = 0) -> EdgeCutPartition:
    """Linear Deterministic Greedy [Stanton & Kliot 2012]: stream vertices;
    assign to the partition with most neighbors, damped by a capacity
    penalty (1 - size/capacity)."""
    n = g.num_nodes
    cap = slack * n / n_parts
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    assign = -np.ones(n, np.int32)
    sizes = np.zeros(n_parts, np.int64)
    for v in order:
        nbrs = g.neighbors(v)
        placed = assign[nbrs]
        placed = placed[placed >= 0]
        score = np.bincount(placed, minlength=n_parts).astype(np.float64)
        score *= np.maximum(0.0, 1.0 - sizes / cap)
        # tie-break: least-loaded
        best = np.flatnonzero(score == score.max())
        p = best[np.argmin(sizes[best])]
        assign[v] = p
        sizes[p] += 1
    return EdgeCutPartition(assign, n_parts)


def fennel_partition(g: Graph, n_parts: int, *, gamma: float = 1.5,
                     seed: int = 0) -> EdgeCutPartition:
    """FENNEL [Tsourakakis+ 2014]: score = |N(v) ∩ P| - α·γ·|P|^(γ-1)."""
    n, m = g.num_nodes, g.num_edges
    alpha = np.sqrt(n_parts) * m / (n ** gamma)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    assign = -np.ones(n, np.int32)
    sizes = np.zeros(n_parts, np.float64)
    for v in order:
        nbrs = g.neighbors(v)
        placed = assign[nbrs]
        placed = placed[placed >= 0]
        nb = np.bincount(placed, minlength=n_parts).astype(np.float64)
        score = nb - alpha * gamma * np.power(sizes, gamma - 1)
        p = int(np.argmax(score))
        assign[v] = p
        sizes[p] += 1
    return EdgeCutPartition(assign, n_parts)


# ===========================================================================
# vertex-cut family
# ===========================================================================

def hdrf_partition(g: Graph, n_parts: int, *, lam: float = 1.0,
                   seed: int = 0) -> VertexCutPartition:
    """HDRF [Petroni+ 2015]: stream edges; replicate High-Degree vertices
    first; balance via a load term."""
    edges = g.edges()
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(edges))
    deg = g.out_degree() + g.in_degree()
    replicas = [set() for _ in range(g.num_nodes)]  # partitions holding v
    load = np.zeros(n_parts, np.float64)
    assign = np.zeros(len(edges), np.int32)
    eps = 1e-9
    for ei in order:
        u, v = edges[ei]
        du, dv = deg[u] + eps, deg[v] + eps
        theta_u = du / (du + dv)
        theta_v = 1 - theta_u
        maxload = load.max() + eps
        minload = load.min()
        scores = np.zeros(n_parts)
        for p in range(n_parts):
            g_u = (1 + (1 - theta_u)) if p in replicas[u] else 0.0
            g_v = (1 + (1 - theta_v)) if p in replicas[v] else 0.0
            bal = lam * (maxload - load[p]) / (eps + maxload - minload)
            scores[p] = g_u + g_v + bal
        p = int(np.argmax(scores))
        assign[ei] = p
        replicas[u].add(p)
        replicas[v].add(p)
        load[p] += 1
    return VertexCutPartition(assign, n_parts, edges)


def grid_vertex_cut(g: Graph, n_parts: int) -> VertexCutPartition:
    """2D grid edge placement (GridGraph/NeuGraph/ZIPPER): edge (u, v) goes
    to block (chunk(u), chunk(v)) arranged on a √P x √P grid."""
    p_side = int(np.sqrt(n_parts))
    if p_side * p_side != n_parts:
        raise ValueError("grid partitioner needs square P")
    edges = g.edges()
    n = g.num_nodes
    cu = (edges[:, 0] * p_side // n).astype(np.int64)
    cv = (edges[:, 1] * p_side // n).astype(np.int64)
    return VertexCutPartition((cu * p_side + cv).astype(np.int32), n_parts,
                              edges)


def two_phase_partition(g: Graph, n_parts: int, *, seed: int = 0
                        ) -> VertexCutPartition:
    """2PS [Mayer+ 2020]: phase 1 gathers clustering information (cheap
    label-propagation communities); phase 2 streams edges and scores
    partitions by cluster affinity + degree + load (HDRF-style)."""
    rng = np.random.default_rng(seed)
    n = g.num_nodes
    # phase 1: a few label-propagation rounds
    labels = np.arange(n)
    for _ in range(3):
        order = rng.permutation(n)
        for v in order:
            nbr = g.neighbors(v)
            if len(nbr) == 0:
                continue
            counts = np.bincount(labels[nbr])
            labels[v] = int(np.argmax(counts))
    _, labels = np.unique(labels, return_inverse=True)
    cluster_part = labels % n_parts          # cluster -> home partition

    # phase 2: stream edges with cluster-affinity scoring under a hard
    # capacity bound (keeps balance even when affinity is sticky)
    edges = g.edges()
    order = rng.permutation(len(edges))
    load = np.zeros(n_parts)
    cap = 1.1 * len(edges) / n_parts
    replicas = [set() for _ in range(n)]
    assign = np.zeros(len(edges), np.int32)
    eps = 1e-9
    for ei in order:
        u, v = edges[ei]
        scores = np.zeros(n_parts)
        maxload = load.max() + eps
        minload = load.min()
        for p in range(n_parts):
            if load[p] >= cap:
                scores[p] = -np.inf
                continue
            s = 0.0
            if p in replicas[u]:
                s += 1.0
            if p in replicas[v]:
                s += 1.0
            if cluster_part[labels[u]] == p:
                s += 0.5
            if cluster_part[labels[v]] == p:
                s += 0.5
            s += 2.0 * (maxload - load[p]) / (eps + maxload - minload)
            scores[p] = s
        p = int(np.argmax(scores))
        assign[ei] = p
        replicas[u].add(p)
        replicas[v].add(p)
        load[p] += 1
    return VertexCutPartition(assign, n_parts, edges)


# ===========================================================================
# hybrid (PowerLyra)
# ===========================================================================

def hybrid_partition(g: Graph, n_parts: int, *, degree_threshold: int = 32,
                     seed: int = 0) -> VertexCutPartition:
    """PowerLyra hybrid-cut: low-degree (in-degree <= θ) vertices keep all
    their in-edges on hash(dst) (edge-cut-like locality); high-degree
    vertices get their in-edges spread by hash(src) (vertex-cut)."""
    edges = g.edges()
    indeg = g.in_degree()
    hp = hash_partition(g, n_parts).assignment

    dst_low = indeg[edges[:, 1]] <= degree_threshold
    assign = np.where(dst_low, hp[edges[:, 1]], hp[edges[:, 0]])
    return VertexCutPartition(assign.astype(np.int32), n_parts, edges)


# ===========================================================================
# registry & dispatch
# ===========================================================================

PARTITIONERS = {
    "hash": hash_partition,
    "ldg": ldg_partition,
    "fennel": fennel_partition,
    "hdrf": hdrf_partition,
    "grid": grid_vertex_cut,
    "hybrid": hybrid_partition,
    "2ps": two_phase_partition,
}


def select_partitioner(g: Graph, n_parts: int, *,
                       latency_budget_s: float = 1.0) -> str:
    """EASE-style automatic selection [Merkel+ 2023, §2.2.2]: predict the
    best strategy from cheap graph statistics instead of running all.

    Heuristic model (validated in tests/benchmarks):
      - heavy-tailed degree distribution  -> vertex-cut (hdrf)
      - uniform degrees + time budget     -> locality streaming (ldg)
      - tight latency budget / huge graph -> hash
    """
    deg = g.out_degree().astype(np.float64)
    mean = max(deg.mean(), 1e-9)
    cv = deg.std() / mean                        # coefficient of variation
    # streaming partitioners cost ~O(N * n_parts) python-side here;
    # calibrate a crude throughput constant
    est_stream_s = g.num_nodes * n_parts * 2e-6
    if est_stream_s > latency_budget_s:
        return "hash"
    if cv > 0.8:                                 # power-law-ish
        return "hdrf"
    return "ldg"


def partition(g: Graph, n_parts: int, method: str = "hash", **kw):
    return PARTITIONERS[method](g, n_parts, **kw)


def contiguousize(g: Graph, part: EdgeCutPartition):
    """Relabel vertices so each partition's vertices are contiguous and
    equally padded — the device-ready layout of the distributed trainer.

    Returns (perm (N,), counts (P,)) with perm[new_id] = old_id.
    """
    order = np.argsort(part.assignment, kind="stable")
    counts = np.bincount(part.assignment, minlength=part.n_parts)
    return order, counts
