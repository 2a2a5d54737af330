"""Inference-time neighbor sampling with fully static shapes.

Reuses :func:`repro_torch.core.sampling.sample_block_padded`: the seed slot array
comes in already padded to a batcher bucket, and each layer expansion emits
a :class:`~repro_torch.core.sampling.Block` whose shape depends only on
``(bucket, fanouts)`` — so a k-layer mini-batch for bucket B always has the
same pytree of shapes and hits one jit entry.

Two serving-specific twists vs. the training samplers:

* **determinism per node** — a node's sampled neighborhood is a pure
  function of ``(seed, layer, node)``, not of request order.  Historical
  embeddings cached for a node therefore describe exactly the neighborhood
  a recompute would use, making cache hits *exact* at staleness 0.
* **expansion masks** — the innermost expansion can be restricted to
  embedding-cache misses; hit nodes keep their slot (shape discipline) but
  get no edges and no feature fetches.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.sampling import Block, MiniBatch, sample_block_padded
from repro_torch.core.updates import k_hop_nodes
from repro_torch.graph.structure import Graph


def _propagate_need(b: Block, need: np.ndarray) -> np.ndarray:
    """Push a dst-slot relevance mask through one block to its src slots:
    a src slot matters if it sits in the prefix of a needed dst (self
    features flow) or feeds a valid edge (edges only exist under
    expanded, i.e. miss-path, dst nodes)."""
    src_need = np.zeros(b.num_src, bool)
    src_need[:b.num_dst] |= need
    src_need[b.edge_src[b.edge_mask]] = True
    return src_need


class ServingSampler:
    """Fixed-shape inference-time neighbor sampler.

    Args:
        g: the served graph (``g.reverse()`` is precomputed for in-edge
            expansion).
        fanouts: per-layer fanout, innermost first — one per model layer.
        seed: base of the per-``(seed, layer, node)`` rng, so a node's
            sampled neighborhood is independent of batch composition.

    Shape convention: seeds arrive padded to a batcher bucket (``-1`` =
    empty slot); every emitted :class:`~repro_torch.core.sampling.Block` has the
    caps declared by :meth:`block_shapes` — a pure function of
    ``(bucket, fanouts)`` — and pad slots carry no edges, so pad rows
    never aggregate into real outputs.
    """

    def __init__(self, g: Graph, fanouts: Sequence[int], *, seed: int = 0):
        self.g = g
        self.gr = g.reverse()
        self.fanouts = list(fanouts)
        self.seed = seed
        # per-(layer, node) pick memo: because a node's pick is a pure
        # function of (seed, layer, node, neighbor list), memoizing it is
        # semantically invisible — it only skips re-deriving the rng.  The
        # delta path (apply_delta) drops exactly the touched entries, so
        # untouched nodes keep their sampled neighborhoods bit-identical
        # across graph mutations (the property the cache relies on).
        self._memo: dict = {}
        self.memo_hits = 0
        self.memo_misses = 0

    def _rng_for(self, layer: int):
        def rng_for(node: int):
            return np.random.default_rng((self.seed, layer, node))
        return rng_for

    def _picker(self, layer: int):
        """Memoizing pick function for :func:`sample_block_padded`: on a
        miss it computes the identical pick the plain rng path would
        (subset of the CURRENT in-neighbor list), then caches it under
        ``(layer, node)`` until a delta touches the node."""
        fanout = self.fanouts[layer]

        def picker(node: int, nbr: np.ndarray) -> np.ndarray:
            key = (layer, node)
            pick = self._memo.get(key)
            if pick is not None:
                self.memo_hits += 1
                return pick
            self.memo_misses += 1
            if len(nbr) <= fanout:
                pick = nbr
            else:
                rng = np.random.default_rng((self.seed, layer, node))
                pick = rng.choice(nbr, fanout, replace=False)
            self._memo[key] = pick
            return pick
        return picker

    # -- delta awareness ---------------------------------------------------
    def apply_delta(self, touched: np.ndarray) -> int:
        """React to a graph mutation whose frontier is ``touched`` node
        ids: rebuild the reversed adjacency (the graph arrays were folded
        in place) and drop the memoized picks of touched nodes across all
        layers, so only they are re-sampled against the new neighbor
        lists.  Untouched nodes keep their exact previous expansion.
        Returns the number of memo entries dropped."""
        self.gr = self.g.reverse()
        dropped = 0
        for node in np.asarray(touched, np.int64):
            for layer in range(len(self.fanouts)):
                if self._memo.pop((layer, int(node)), None) is not None:
                    dropped += 1
        return dropped

    def affected_seed_mask(self, seeds: np.ndarray,
                           touched: np.ndarray) -> np.ndarray:
        """Which ``seeds`` (padded, -1 = empty) have a k-hop sampled ball
        that can intersect the ``touched`` delta frontier — the only
        seeds whose outputs may change, so the only ones a delta-aware
        caller must re-serve.  Conservative: uses the full k-hop
        neighborhood (a superset of any sampled subset)."""
        ball = k_hop_nodes(self.g, np.asarray(touched, np.int64),
                           len(self.fanouts))
        hit = np.zeros(self.g.num_nodes, bool)
        hit[ball] = True
        seeds = np.asarray(seeds, np.int64)
        return (seeds >= 0) & hit[np.maximum(seeds, 0)]

    # -- shape contract ----------------------------------------------------
    def block_shapes(self, bucket: int) -> List[Tuple[int, int, int]]:
        """Declared (dst_cap, src_cap, edge_cap) per block, innermost
        first — the bucket invariant tests assert emitted blocks match."""
        caps = []
        d = bucket
        for f in reversed(self.fanouts):       # outermost first
            caps.append((d, d * (1 + f), d * f))
            d = d * (1 + f)
        caps.reverse()
        return caps

    # -- sampling ----------------------------------------------------------
    def sample_outer(self, padded_seeds: np.ndarray) -> Block:
        """The final-layer block: seeds aggregate from their sampled
        1-hop neighborhood.  Always fully expanded (the last layer is
        never served from cache — its inputs may be)."""
        layer = len(self.fanouts) - 1
        return sample_block_padded(
            self.g, self.gr, padded_seeds, self.fanouts[-1],
            self._rng_for(layer), picker=self._picker(layer))

    def sample_inner(self, dst: np.ndarray,
                     expand: Optional[np.ndarray] = None) -> List[Block]:
        """Expand the remaining ``k-1`` layers below ``dst`` (the outer
        block's src nodes), innermost first.  ``expand`` restricts the
        first expansion to cache misses; deeper layers restrict
        automatically because unexpanded nodes contribute no srcs."""
        blocks: List[Block] = []
        for layer in reversed(range(len(self.fanouts) - 1)):
            b = sample_block_padded(self.g, self.gr, dst,
                                    self.fanouts[layer],
                                    self._rng_for(layer), expand=expand,
                                    picker=self._picker(layer))
            blocks.append(b)
            if expand is not None:
                expand = _propagate_need(b, expand)
            dst = b.src_nodes
        blocks.reverse()
        return blocks

    def sample(self, padded_seeds: np.ndarray,
               expand_inner: Optional[np.ndarray] = None) -> MiniBatch:
        """Full k-layer mini-batch for one micro-batch of seed slots."""
        outer = self.sample_outer(padded_seeds)
        inner = self.sample_inner(outer.src_nodes, expand_inner)
        blocks = inner + [outer]
        return MiniBatch(blocks, np.asarray(padded_seeds, np.int64),
                         blocks[0].src_nodes)


def needed_feature_mask(blocks: List[Block], need_dst: np.ndarray) -> np.ndarray:
    """Which input-feature rows (blocks[0].src_nodes slots) are actually
    required to compute the representations of the ``need_dst``-marked dst
    slots of the OUTERMOST inner block (= embedding-cache misses).

    Walks outer→inner via :func:`_propagate_need` — the same propagation
    rule ``sample_inner`` uses to restrict expansion, so which rows are
    fetched always matches which nodes were expanded."""
    need = np.asarray(need_dst, bool)
    for b in reversed(blocks):
        assert len(need) == b.num_dst
        need = _propagate_need(b, need)
    return need
