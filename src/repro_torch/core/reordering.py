"""Vertex reordering (survey §3.2.4: GNNAdvisor's neighbor grouping via
Rabbit-order-style community locality; ZIPPER's degree sorting; classic
reverse Cuthill–McKee bandwidth reduction).

Reordering assigns consecutive ids to vertices that share neighbors so the
aggregation phase's gathers hit nearby rows (L1/L2 locality).  Three
policies are provided plus pure-numpy locality metrics so the benefit is
measurable on any graph + access trace:

* :func:`degree_sort_order` — ZIPPER: descending out-degree.
* :func:`bfs_locality_order` — Rabbit-order stand-in: BFS from max-degree
  roots groups communities contiguously (deque frontier, O(N + E)).
* :func:`rcm_order` — reverse Cuthill–McKee on the symmetrized adjacency:
  minimizes edge bandwidth ``|src - dst|``, which maps directly onto the
  blocked kernels' tile density (edges concentrate near the diagonal, so
  fewer (node-tile, edge-tile) pairs are active).

Every policy is deterministic: ties break by ascending node id through
stable sorts, so the same graph always packs the same way — the property
the fold-then-reorder dynamic-graph regression and the distributed
equivalence tests rely on.

:func:`reorder_graph` is the first-class transform behind
``Graph.reordered(policy)`` and the launchers' ``--reorder`` flag: it
returns ``(packed_graph, perm, inv)`` with ``perm[new_id] = old_id`` and
``inv[old_id] = new_id``, so callers map external ids in via ``inv`` and
report results back in original ids via ``perm``.

The reference's ``record_tile_density`` (``repro/kernels/ops.py``)
is not copied: it measures the TPU kernels' one-hot (node-tile,
edge-tile) blocks, which the Hopper kernels, segmented reductions over
host-built grouped layouts, do not have.  Locality shows on the card as
the gathers' time against their gather bound (``chip_smoke.py``).
"""
from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.graph.structure import Graph, from_edges


def identity_order(g: Graph) -> np.ndarray:
    """The no-op policy: perm[new_id] = new_id."""
    return np.arange(g.num_nodes, dtype=np.int64)


def degree_sort_order(g: Graph) -> np.ndarray:
    """ZIPPER's heuristic: sort vertices by descending out-degree.
    Returns perm with perm[new_id] = old_id (ties: ascending node id —
    ``argsort(kind="stable")`` keeps the original order of equal keys)."""
    return np.argsort(-g.out_degree(), kind="stable")


def bfs_locality_order(g: Graph, *, seed: int = 0) -> np.ndarray:
    """Rabbit-order stand-in: BFS from a max-degree root groups
    communities contiguously (GNNAdvisor's 'neighbor groups get
    consecutive ids').

    The frontier is a :class:`collections.deque` — ``popleft`` is O(1),
    so the whole traversal is O(N + E) (the previous ``list.pop(0)``
    frontier made it O(N²) on long BFS levels).  Deterministic: roots by
    (descending degree, ascending id); neighbors enqueue in CSR
    (ascending id) order.
    """
    n = g.num_nodes
    visited = np.zeros(n, bool)
    order = []
    deg = g.out_degree()
    roots = np.argsort(-deg, kind="stable")
    for root in roots:
        if visited[root]:
            continue
        queue = deque([int(root)])
        visited[root] = True
        while queue:
            v = queue.popleft()
            order.append(v)
            for u in g.neighbors(v):
                if not visited[u]:
                    visited[u] = True
                    queue.append(int(u))
    return np.asarray(order, np.int64)


def rcm_order(g: Graph) -> np.ndarray:
    """Reverse Cuthill–McKee on the symmetrized adjacency.

    Classic bandwidth-reduction ordering: BFS from a minimum-degree root,
    visiting each vertex's unvisited neighbors in ascending-degree order
    (ties: ascending id), then reverse.  Low bandwidth means edge
    endpoints land in the same or adjacent id tiles, so a gather's
    source rows of neighbouring destinations lie close together.
    """
    n = g.num_nodes
    e = g.edges()
    adj = from_edges(n, np.concatenate([e, e[:, [1, 0]]], axis=0))
    deg = adj.out_degree()
    visited = np.zeros(n, bool)
    order = []
    roots = np.argsort(deg, kind="stable")       # min-degree roots first
    for root in roots:
        if visited[root]:
            continue
        queue = deque([int(root)])
        visited[root] = True
        while queue:
            v = queue.popleft()
            order.append(v)
            nb = np.unique(adj.neighbors(v))
            nb = nb[~visited[nb]]
            nb = nb[np.argsort(deg[nb], kind="stable")]
            visited[nb] = True
            queue.extend(int(u) for u in nb)
    return np.asarray(order[::-1], np.int64)


def apply_order(g: Graph, perm: np.ndarray) -> Graph:
    """Relabel the graph: new id i = old id perm[i].  Features, labels and
    CSR structure are permuted consistently (edges re-sorted by new src
    id via the stable ``from_edges`` build)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    e = g.edges()
    g2 = from_edges(g.num_nodes,
                    np.stack([inv[e[:, 0]], inv[e[:, 1]]], axis=1),
                    features=None if g.features is None
                    else g.features[perm],
                    labels=None if g.labels is None else g.labels[perm],
                    num_classes=g.num_classes)
    return g2


def reorder_graph(g: Graph, policy: str = "bfs"):
    """Apply a reordering policy end-to-end.

    Returns ``(packed, perm, inv)``: ``packed`` is the relabeled graph,
    ``perm[new_id] = old_id`` and ``inv[old_id] = new_id`` (mutual
    inverses — ``perm[inv] == arange(n)``).  Callers translate external
    node ids into the packed space with ``inv`` and report packed results
    in original ids with ``perm``; ``policy="none"`` returns the graph
    unchanged with identity maps, so call sites need no special-casing.
    """
    if policy not in REORDER_POLICIES:
        raise KeyError(f"unknown reorder policy {policy!r}; "
                       f"choose from {sorted(REORDER_POLICIES)}")
    perm = REORDER_POLICIES[policy](g)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    if policy == "none":
        return g, perm, inv
    return apply_order(g, perm), perm, inv


# ---------------------------------------------------------------------------
# locality metrics (pure numpy — the measurable half of the claim)
# ---------------------------------------------------------------------------

def edge_locality(g: Graph, *, window: int = 128) -> float:
    """Fraction of edges whose endpoints fall within a ``window``-row id
    band — a proxy for cache-line co-residency during gathers."""
    e = g.edges()
    if len(e) == 0:
        return 0.0
    return float(np.mean(np.abs(e[:, 0] - e[:, 1]) < window))


def avg_gather_stride(g: Graph) -> float:
    """Mean absolute id step between consecutively touched rows as the
    aggregation walks the edge list in CSR order — the source stream is
    the gather side, the destination stream the scatter side; both are
    averaged.  0 on an edgeless graph; lower is better (sequential access
    has stride ≈ 0, random access ≈ N/3)."""
    e = g.edges()
    if len(e) < 2:
        return 0.0
    return float((np.mean(np.abs(np.diff(e[:, 0])))
                  + np.mean(np.abs(np.diff(e[:, 1])))) / 2.0)


def reuse_distance_hit_rate(g: Graph, *, window: int = 1024) -> float:
    """Fraction of destination-row accesses whose previous access to the
    same row happened within the last ``window`` accesses — an LRU-style
    reuse-distance proxy for how often the scatter target is still
    cache resident.  First-ever accesses count as misses; an
    edgeless graph scores 0."""
    dst = g.edges()[:, 1] if g.num_edges else np.zeros(0, np.int64)
    if len(dst) == 0:
        return 0.0
    pos = np.arange(len(dst))
    order = np.lexsort((pos, dst))
    sd, sp = dst[order], pos[order]
    same = sd[1:] == sd[:-1]
    gaps = sp[1:] - sp[:-1]
    hits = int(np.sum(same & (gaps <= window)))
    return hits / len(dst)


def locality_report(g: Graph, *, window: int = 128,
                    reuse_window: int = 1024) -> dict:
    """All locality metrics in one dict (what the launchers surface into
    telemetry under ``--reorder`` and the bench writes per policy)."""
    return {
        "edge_locality": edge_locality(g, window=window),
        "avg_gather_stride": avg_gather_stride(g),
        "reuse_hit_rate": reuse_distance_hit_rate(g, window=reuse_window),
    }


REORDER_POLICIES = {
    "none": identity_order,
    "degree": degree_sort_order,     # ZIPPER
    "bfs": bfs_locality_order,       # GNNAdvisor / Rabbit-order stand-in
    "rcm": rcm_order,                # reverse Cuthill–McKee
}

# legacy aliases (bench_caching + older tests predate the launcher flag)
REORDERINGS = {
    "identity": identity_order,
    "degree": degree_sort_order,
    "bfs_locality": bfs_locality_order,
}
