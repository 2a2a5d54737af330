"""Graph substrate: CSR graphs (host-side numpy for preprocessing,
device-side torch views for the model).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Graph:
    """Directed graph in CSR form.  For undirected graphs both directions
    are stored explicitly."""
    row_ptr: np.ndarray          # (N+1,) int64
    col_idx: np.ndarray          # (E,)  int32 — out-neighbors
    features: Optional[np.ndarray] = None   # (N, F) float32
    labels: Optional[np.ndarray] = None     # (N,)  int32
    num_classes: int = 0

    @property
    def num_nodes(self) -> int:
        return len(self.row_ptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.col_idx)

    def out_degree(self) -> np.ndarray:
        return np.diff(self.row_ptr).astype(np.int64)

    def in_degree(self) -> np.ndarray:
        return np.bincount(self.col_idx, minlength=self.num_nodes
                           ).astype(np.int64)

    def neighbors(self, v: int) -> np.ndarray:
        return self.col_idx[self.row_ptr[v]:self.row_ptr[v + 1]]

    def edges(self) -> np.ndarray:
        """(E, 2) [src, dst] array."""
        src = np.repeat(np.arange(self.num_nodes), self.out_degree())
        return np.stack([src, self.col_idx.astype(np.int64)], axis=1)

    def reverse(self) -> "Graph":
        e = self.edges()
        return from_edges(self.num_nodes, e[:, [1, 0]],
                          features=self.features, labels=self.labels,
                          num_classes=self.num_classes)

    def subgraph(self, nodes: np.ndarray) -> "Graph":
        """Induced subgraph; node ids are re-indexed to [0, len(nodes))."""
        nodes = np.asarray(nodes)
        remap = -np.ones(self.num_nodes, np.int64)
        remap[nodes] = np.arange(len(nodes))
        src_all = np.repeat(np.arange(self.num_nodes), self.out_degree())
        keep = (remap[src_all] >= 0) & (remap[self.col_idx] >= 0)
        e = np.stack([remap[src_all[keep]], remap[self.col_idx[keep]]],
                     axis=1)
        return from_edges(
            len(nodes), e,
            features=None if self.features is None else self.features[nodes],
            labels=None if self.labels is None else self.labels[nodes],
            num_classes=self.num_classes)

    def reordered(self, policy: str = "bfs"):
        """Locality-reordered copy (survey §3.2.4): returns
        ``(packed, perm, inv)`` where ``packed`` is this graph relabeled
        by the policy (``none``/``degree``/``bfs``/``rcm``),
        ``perm[new_id] = old_id`` and ``inv[old_id] = new_id``.  External
        node ids map into the packed space via ``inv`` and packed results
        are reported in original ids via ``perm`` — the id round-trip the
        launchers' ``--reorder`` flag relies on."""
        from repro_torch.core.reordering import reorder_graph
        return reorder_graph(self, policy)


def from_edges(num_nodes: int, edges: np.ndarray, *, features=None,
               labels=None, num_classes: int = 0) -> Graph:
    """Build CSR from an (E, 2) [src, dst] edge list (dedup not applied)."""
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    order = np.argsort(edges[:, 0], kind="stable")
    edges = edges[order]
    counts = np.bincount(edges[:, 0], minlength=num_nodes)
    row_ptr = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return Graph(row_ptr=row_ptr, col_idx=edges[:, 1].astype(np.int32),
                 features=features, labels=labels, num_classes=num_classes)


def make_undirected(num_nodes: int, edges: np.ndarray, **kw) -> Graph:
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    both = np.concatenate([e, e[:, [1, 0]]], axis=0)
    both = np.unique(both, axis=0)
    both = both[both[:, 0] != both[:, 1]]
    return from_edges(num_nodes, both, **kw)
