"""Named synthetic dataset registry (survey Table 9 stand-ins).

No external downloads are available in this container, so each registry
entry is a deterministic synthetic graph whose *shape class* matches a
dataset family from the survey's Table 9 (size, density, degree skew,
task) — enough to exercise every system path at the right regime.

Each entry returns a featurized Graph plus train/val/test node masks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.graph import generators as G
from repro_torch.graph.structure import Graph


@dataclasses.dataclass
class Dataset:
    name: str
    graph: Graph
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray
    task: str                      # vertex | edge


def _splits(n: int, rng, train=0.6, val=0.2):
    order = rng.permutation(n)
    tr = np.zeros(n, bool)
    va = np.zeros(n, bool)
    te = np.zeros(n, bool)
    a, b = int(n * train), int(n * (train + val))
    tr[order[:a]] = True
    va[order[a:b]] = True
    te[order[b:]] = True
    return tr, va, te


def _make(name: str, g: Graph, seed: int, task="vertex") -> Dataset:
    rng = np.random.default_rng(seed + 1000)
    tr, va, te = _splits(g.num_nodes, rng)
    return Dataset(name, g, tr, va, te, task)


def citeseer_like(seed: int = 0) -> Dataset:
    """~3k nodes, ~1.4 avg degree, 6 classes (citation-graph regime)."""
    g = G.sbm(3300, 6, p_in=0.15, p_out=0.002, seed=seed)
    g = G.featurize(g, 64, seed=seed, class_sep=1.2)
    return _make("citeseer-like", g, seed)


def pubmed_like(seed: int = 0) -> Dataset:
    """~20k nodes, low density, 3 classes."""
    g = G.sbm(19_700, 3, p_in=0.05, p_out=0.001, seed=seed)
    g = G.featurize(g, 128, seed=seed, class_sep=1.0)
    return _make("pubmed-like", g, seed)


def reddit_like(seed: int = 0, scale: float = 0.02) -> Dataset:
    """Power-law community graph (Reddit regime, scaled by ``scale`` so it
    runs on CPU: default ~4.7k nodes, heavy-tailed degrees)."""
    n = int(233_000 * scale)
    g = G.barabasi_albert(n, 8, seed=seed)
    g = G.featurize(g, 64, seed=seed, num_classes=16, class_sep=1.0)
    return _make("reddit-like", g, seed)


def livejournal_like(seed: int = 0, scale: float = 0.002) -> Dataset:
    """Large sparse social graph (LiveJournal regime, scaled)."""
    n = int(4_847_000 * scale)
    g = G.barabasi_albert(n, 7, seed=seed)
    g = G.featurize(g, 32, seed=seed, num_classes=8)
    return _make("livejournal-like", g, seed, task="edge")


DATASETS = {
    "citeseer-like": citeseer_like,
    "pubmed-like": pubmed_like,
    "reddit-like": reddit_like,
    "livejournal-like": livejournal_like,
}


def load(name: str, **kw) -> Dataset:
    return DATASETS[name](**kw)
