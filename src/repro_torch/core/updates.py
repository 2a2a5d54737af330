"""Streaming graph updates: the append-only edge/node update log.

The survey's dynamic-GNN-systems lineage (temporal/evolving-graph systems,
§3.3) treats a mutating graph as a *stream of updates* folded into an
otherwise-static snapshot: edges appear and disappear, node features
drift, and every derived structure — historical-embedding caches, halo
ghost buffers, sampled neighborhoods — must be invalidated *incrementally*
(only where the delta actually reaches) instead of rebuilt cold.

This module is the substrate all of that keys off:

* :class:`GraphUpdateLog` — an append-only log of
  ``add_edge`` / ``remove_edge`` / ``update_features`` events with
  monotone sequence numbers, each stamped with the shared
  :class:`~repro_torch.core.caching.VersionClock` at append time (the same
  clock the staleness-bounded caches age against);
* :meth:`GraphUpdateLog.apply` — fold a seq range of events into a
  :class:`~repro_torch.graph.structure.Graph` and return a NEW snapshot.
  Because :func:`~repro_torch.graph.structure.from_edges` stable-sorts by
  source, applying ``[0, s1]`` then ``(s1, s2]`` is *bitwise identical*
  to applying ``[0, s2]`` in one shot — the composition property the
  hypothesis suite asserts and the delta-vs-rebuild equivalence tests
  build on;
* :meth:`GraphUpdateLog.delta` — the touched node/edge sets of a seq
  range, the seed of every incremental-invalidation frontier;
* :func:`k_hop_nodes` / :func:`fold_in_place` — frontier expansion and
  the in-place fold that lets every holder of a shared ``Graph`` object
  (samplers, feature stores, caches, trainers) observe the post-update
  structure without re-plumbing references.

Telemetry: every appended event counts into
``graph_updates_total{kind}``; :meth:`GraphUpdateLog.reset_stats`
resets the series and the instance counters in lockstep (the
warmup-reset rule every accounted subsystem follows).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterator, List, Optional

import numpy as np

from repro_torch.core import telemetry
from repro_torch.core.caching import VersionClock
from repro_torch.graph.structure import Graph, from_edges

__all__ = ["GraphUpdate", "UpdateDelta", "GraphUpdateLog", "k_hop_nodes",
           "fold_in_place", "load_update_stream", "synthesize_updates",
           "UPDATE_KINDS"]

UPDATE_KINDS = ("add_edge", "remove_edge", "update_features")


@dataclasses.dataclass(frozen=True)
class GraphUpdate:
    """One immutable event of the update stream.

    Attributes:
        seq: monotone 1-based sequence number (``seq=0`` is reserved for
            "the base graph, nothing applied").
        kind: one of :data:`UPDATE_KINDS`.
        u: source node (``add_edge``/``remove_edge``) or the updated node
            (``update_features``).
        v: destination node of an edge event; ``-1`` for feature events.
        x: replacement feature row for ``update_features``; ``None``
            otherwise.
        clock: value of the shared version clock when the event was
            appended — the tick invalidations of this event are ordered
            against.
    """
    seq: int
    kind: str
    u: int
    v: int = -1
    x: Optional[np.ndarray] = None
    clock: int = 0


@dataclasses.dataclass(frozen=True)
class UpdateDelta:
    """Touched sets of a seq range ``(from_seq, to_seq]``.

    Attributes:
        from_seq / to_seq: the half-open range the delta covers.
        nodes: sorted unique node ids touched — both endpoints of every
            edge event plus the node of every feature event.
        edges: ``(K, 2)`` ``[u, v]`` pairs of the edge events (adds and
            removes alike; duplicates preserved in stream order).
        n_events: number of events in the range.
    """
    from_seq: int
    to_seq: int
    nodes: np.ndarray
    edges: np.ndarray
    n_events: int


class GraphUpdateLog:
    """Append-only streaming edge/node update log.

    Args:
        clock: share an existing
            :class:`~repro_torch.core.caching.VersionClock`
            (e.g. a serving cache's) so event stamps are ordered against
            the same staleness epochs; default: a private clock at 0.

    Events get monotone sequence numbers starting at 1; ``apply(g, s)``
    folds events ``1..s`` into ``g`` and ``apply(g1, s2, from_seq=s1)``
    continues from an earlier snapshot — bitwise identical to the
    one-shot fold (see module docstring).  ``remove_edge`` removes ALL
    stored copies of ``(u, v)`` present at its point in the stream and
    is a no-op when the edge is absent (lenient, so replaying a stream
    against divergent snapshots cannot raise mid-fold).
    """

    def __init__(self, *, clock: Optional[VersionClock] = None):
        self.clock = clock if clock is not None else VersionClock()
        self.events: List[GraphUpdate] = []
        self.counts = {k: 0 for k in UPDATE_KINDS}
        self._m = {k: telemetry.counter(
            "graph_updates_total", "graph update events appended to the "
            "streaming update log", kind=k) for k in UPDATE_KINDS}

    # -- append ------------------------------------------------------------
    def _append(self, kind: str, u: int, v: int,
                x: Optional[np.ndarray]) -> GraphUpdate:
        ev = GraphUpdate(seq=len(self.events) + 1, kind=kind, u=int(u),
                         v=int(v), x=x, clock=self.clock.now)
        self.events.append(ev)
        self.counts[kind] += 1
        self._m[kind].inc()
        return ev

    def add_edge(self, u: int, v: int) -> GraphUpdate:
        """Append an ``add_edge`` event for the directed edge ``u -> v``
        (undirected graphs append both directions as two events)."""
        return self._append("add_edge", u, v, None)

    def remove_edge(self, u: int, v: int) -> GraphUpdate:
        """Append a ``remove_edge`` event: at apply time every stored copy
        of ``u -> v`` present at this point in the stream is dropped."""
        return self._append("remove_edge", u, v, None)

    def update_features(self, node: int, x: np.ndarray) -> GraphUpdate:
        """Append an ``update_features`` event replacing ``node``'s
        feature row with ``x`` at apply time."""
        return self._append("update_features", node, -1,
                            np.asarray(x, np.float32))

    @property
    def last_seq(self) -> int:
        """Highest appended sequence number (0 on an empty log)."""
        return len(self.events)

    def relabel(self, inv: np.ndarray) -> "GraphUpdateLog":
        """New log with every event's node ids mapped through ``inv``
        (``inv[old_id] = new_id``) — the adapter that lets an
        original-id update stream fold into a locality-packed graph
        (``Graph.reordered``): folding commutes with relabeling, so
        ``fold(packed, log.relabel(inv))`` is the relabeling of
        ``fold(g, log)`` under the same permutation (the
        fold-then-reorder regression in ``tests/test_dynamic_graph.py``).
        Seq numbers, clock stamps, and counts are preserved; telemetry
        counters are NOT re-incremented (relabeled events are not new
        events)."""
        inv = np.asarray(inv)
        out = GraphUpdateLog(clock=self.clock)
        for ev in self.events:
            out.events.append(dataclasses.replace(
                ev, u=int(inv[ev.u]),
                v=int(inv[ev.v]) if ev.v >= 0 else -1))
            out.counts[ev.kind] += 1
        return out

    def events_between(self, from_seq: int,
                       to_seq: int) -> Iterator[GraphUpdate]:
        """Iterate events with ``from_seq < seq <= to_seq`` in order."""
        if not 0 <= from_seq <= to_seq <= self.last_seq:
            raise ValueError(
                f"bad seq range ({from_seq}, {to_seq}] for a log of "
                f"{self.last_seq} events")
        return iter(self.events[from_seq:to_seq])

    # -- fold --------------------------------------------------------------
    def apply(self, g: Graph, upto_seq: Optional[int] = None, *,
              from_seq: int = 0) -> Graph:
        """Fold events ``(from_seq, upto_seq]`` into ``g`` and return a
        new :class:`~repro_torch.graph.structure.Graph` snapshot (``g``
        itself is never mutated; labels are shared, features are copied
        when present).

        ``upto_seq=None`` means "everything appended so far".  Passing a
        snapshot produced by an earlier ``apply(g, s1)`` with
        ``from_seq=s1`` continues the fold — and yields a CSR bitwise
        identical to the one-shot ``apply(g, s2)``, because
        :func:`~repro_torch.graph.structure.from_edges` stable-sorts by
        source (appends keep their relative order inside each source row, and
        removal commutes with a stable sort).

        The edge list is the reference's: the stored edges in CSR order,
        then each added edge, with every copy of a removed pair present at
        its remove event dropped.  Instead of filtering the whole list at
        each remove, only the pairs some remove event names are indexed
        (their stored positions), so a fold costs one pass over the edges
        plus one step an event.
        """
        upto = self.last_seq if upto_seq is None else upto_seq
        n = g.num_nodes
        events = list(self.events_between(from_seq, upto))
        base = g.edges()
        doomed = {(ev.u, ev.v) for ev in events
                  if ev.kind == "remove_edge" and ev.v >= 0}
        # pair -> positions of its stored copies, for the doomed pairs
        copies: dict = {}
        if doomed:
            keys = base[:, 0] * n + base[:, 1]
            want = np.asarray([u * n + v for u, v in doomed], np.int64)
            for pos in np.flatnonzero(np.isin(keys, want)):
                copies.setdefault((int(base[pos, 0]), int(base[pos, 1])),
                                  []).append(int(pos))
        added: list = []
        alive = np.ones(len(base) + len(events), bool)
        feats = None if g.features is None else np.array(g.features)
        for ev in events:
            if not (0 <= ev.u < n and (ev.v < n)):
                raise ValueError(f"event seq={ev.seq} touches node out of "
                                 f"range for a {n}-node graph")
            if ev.kind == "add_edge":
                if ev.v < 0:
                    raise ValueError(f"event seq={ev.seq}: bad dst {ev.v}")
                if (ev.u, ev.v) in doomed:
                    copies.setdefault((ev.u, ev.v), []).append(
                        len(base) + len(added))
                added.append((ev.u, ev.v))
            elif ev.kind == "remove_edge":
                alive[copies.pop((ev.u, ev.v), [])] = False
            else:                                  # update_features
                if feats is None:
                    raise ValueError("update_features on a featureless "
                                     "graph")
                x = np.asarray(ev.x, feats.dtype)
                if x.shape != feats.shape[1:]:
                    raise ValueError(
                        f"event seq={ev.seq}: update_features payload has "
                        f"shape {x.shape} but the graph's feature rows are "
                        f"{feats.shape[1:]} — the stream was recorded "
                        f"against a different featurization")
                feats[ev.u] = x
        e = np.concatenate([base, np.asarray(added, np.int64).reshape(-1, 2)])
        return from_edges(n, e[alive[:len(e)]], features=feats,
                          labels=g.labels, num_classes=g.num_classes)

    def delta(self, from_seq: int,
              to_seq: Optional[int] = None) -> UpdateDelta:
        """Touched node/edge sets of ``(from_seq, to_seq]`` — the seed of
        every incremental-invalidation frontier.  Union over sub-ranges
        is a superset of (in fact equal to) the full range's sets."""
        to = self.last_seq if to_seq is None else to_seq
        nodes, edges, k = [], [], 0
        for ev in self.events_between(from_seq, to):
            k += 1
            if ev.kind == "update_features":
                nodes.append(ev.u)
            else:
                nodes.extend((ev.u, ev.v))
                edges.append((ev.u, ev.v))
        return UpdateDelta(
            from_seq=from_seq, to_seq=to,
            nodes=np.unique(np.asarray(nodes, np.int64)),
            edges=(np.asarray(edges, np.int64).reshape(-1, 2)
                   if edges else np.zeros((0, 2), np.int64)),
            n_events=k)

    # -- persistence -------------------------------------------------------
    def to_jsonl(self, path: str) -> int:
        """Write the stream as JSONL (one event per line; the
        ``--update-stream`` wire format) and return the event count."""
        with open(path, "w") as f:
            for ev in self.events:
                rec = {"kind": ev.kind, "u": ev.u}
                if ev.kind == "update_features":
                    rec["x"] = [float(v) for v in ev.x]
                else:
                    rec["v"] = ev.v
                f.write(json.dumps(rec) + "\n")
        return len(self.events)

    # -- accounting --------------------------------------------------------
    def reset_stats(self) -> None:
        """Zero the per-kind event counters and their
        ``graph_updates_total`` telemetry series in lockstep (events
        themselves are state, not accounting, and are kept)."""
        for k in UPDATE_KINDS:
            self.counts[k] = 0
            self._m[k].reset()

    def stats(self) -> dict:
        """Per-kind event counts plus the log's seq horizon."""
        out = {f"events_{k}": v for k, v in self.counts.items()}
        out["last_seq"] = self.last_seq
        return out


def load_update_stream(path: str, *,
                       clock: Optional[VersionClock] = None
                       ) -> GraphUpdateLog:
    """Load a JSONL update stream (see :meth:`GraphUpdateLog.to_jsonl`)
    into a fresh :class:`GraphUpdateLog` stamped on ``clock``."""
    log = GraphUpdateLog(clock=clock)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec["kind"]
            if kind == "add_edge":
                log.add_edge(rec["u"], rec["v"])
            elif kind == "remove_edge":
                log.remove_edge(rec["u"], rec["v"])
            elif kind == "update_features":
                log.update_features(rec["u"], np.asarray(rec["x"],
                                                         np.float32))
            else:
                raise ValueError(f"unknown update kind {kind!r}")
    return log


def k_hop_nodes(g: Graph, nodes: np.ndarray, hops: int) -> np.ndarray:
    """Nodes within ``hops`` edge traversals of ``nodes``, following BOTH
    edge directions (conservative: a superset of any pull- or
    push-direction reachability, so invalidating this set is always
    safe).  Returns sorted unique node ids including the seeds."""
    touched = np.zeros(g.num_nodes, bool)
    touched[np.asarray(nodes, np.int64)] = True
    if hops > 0 and g.num_edges:
        e = g.edges()
        for _ in range(hops):
            before = int(touched.sum())
            touched[e[touched[e[:, 0]], 1]] = True
            touched[e[touched[e[:, 1]], 0]] = True
            if int(touched.sum()) == before:
                break
    return np.flatnonzero(touched)


def fold_in_place(g: Graph, log: GraphUpdateLog, from_seq: int,
                  upto_seq: Optional[int] = None, *,
                  hops: int = 0) -> tuple:
    """Fold ``(from_seq, upto_seq]`` into ``g`` BY MUTATION and return
    ``(delta, frontier)``.

    The shared ``Graph`` object's CSR arrays and feature matrix are
    replaced in place, so every holder of the same object — samplers,
    feature stores, caches, trainers — observes the post-update graph
    without any reference re-plumbing (feature reads are live by
    construction; structural readers must still be told via their
    ``apply_delta``-style hooks).

    ``frontier`` is the sorted union of the ``hops``-hop neighborhoods of
    the touched nodes on the PRE-update and POST-update graphs — the set
    of nodes whose k-hop computation tree can differ, i.e. exactly what
    an embedding cache must invalidate for delta == rebuild to hold.
    """
    upto = log.last_seq if upto_seq is None else upto_seq
    delta = log.delta(from_seq, upto)
    pre = (k_hop_nodes(g, delta.nodes, hops) if len(delta.nodes)
           else np.zeros(0, np.int64))
    new_g = log.apply(g, upto, from_seq=from_seq)
    g.row_ptr = new_g.row_ptr
    g.col_idx = new_g.col_idx
    if new_g.features is not None:
        g.features = new_g.features
    post = (k_hop_nodes(g, delta.nodes, hops) if len(delta.nodes)
            else np.zeros(0, np.int64))
    return delta, np.union1d(pre, post)


def synthesize_updates(g: Graph, n_events: int, *, seed: int = 0,
                       feature_frac: float = 0.5,
                       log: Optional[GraphUpdateLog] = None
                       ) -> GraphUpdateLog:
    """Generate a deterministic synthetic update stream against ``g``:
    ``feature_frac`` of the events perturb a random node's feature row,
    the rest alternate edge additions (random non-self pairs) and
    removals of edges present in ``g`` — the stream the dynamic bench
    and dev-smoke stage replay.  Appends into ``log`` when given."""
    rng = np.random.default_rng(seed)
    out = log if log is not None else GraphUpdateLog()
    e = g.edges()
    for i in range(n_events):
        if g.features is not None and rng.random() < feature_frac:
            node = int(rng.integers(g.num_nodes))
            row = g.features[node] + rng.normal(
                scale=0.1, size=g.features.shape[1]).astype(np.float32)
            out.update_features(node, row)
        elif i % 2 == 0 or not len(e):
            u = int(rng.integers(g.num_nodes))
            v = int(rng.integers(g.num_nodes))
            if u == v:
                v = (v + 1) % g.num_nodes
            out.add_edge(u, v)
        else:
            u, v = (int(x) for x in e[rng.integers(len(e))])
            out.remove_edge(u, v)
    return out
