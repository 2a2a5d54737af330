"""Quickstart: the survey's design space in ~60 lines (the reference's
``examples/quickstart.py`` on the port).

Builds a synthetic community graph, partitions it with three strategies,
samples mini-batches three ways, replays them against two feature-cache
policies, trains a GCN through the SAGA-NN abstraction, and prints the
survey-claim numbers as it goes.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core import caching as CA
from repro_torch.core import partitioning as P
from repro_torch.core import sampling as SA
from repro_torch.core.abstraction import DeviceGraph
from repro_torch.graph import generators as G
from repro_torch.models.gnn import model as GM
from repro_torch.models.gnn.model import GNNConfig
from repro_torch.optim import AdamW


def main(argv=None) -> dict:
    """Runs the walkthrough; returns its numbers (replication factors and
    balance by partitioner, input nodes by sampler, the 2-hop growth,
    hit ratios by cache policy, the GCN's final loss and accuracy)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises when CUDA is "
                         "missing)")
    args = ap.parse_args(argv)
    dev = D.resolve(args.device)
    out: dict = {}

    # --- a graph with planted communities + class-clustered features ------
    g = G.sbm(600, 4, p_in=0.9, p_out=0.02, seed=0)
    g = G.featurize(g, 32, seed=0, class_sep=1.5)
    print(f"graph: {g.num_nodes} nodes / {g.num_edges} edges / 4 classes")

    # --- partitioning (survey §3.2.1) --------------------------------------
    out["partitioners"] = {}
    for method in ("hash", "ldg", "hdrf"):
        p = P.partition(g, 4, method)
        rf = p.replication_factor(g)
        kind = ("edge-cut" if isinstance(p, P.EdgeCutPartition)
                else "vertex-cut")
        out["partitioners"][method] = {"replication_factor": rf,
                                       "balance": p.balance()}
        print(f"partitioner {method:6s} ({kind:10s}): replication factor "
              f"{rf:.2f}, balance {p.balance():.2f}")

    # --- sampling (survey §3.2.2) ------------------------------------------
    seeds = np.arange(32)
    out["growth"] = SA.neighborhood_growth(g, seeds, hops=2)
    full = out["growth"][-1]
    out["sampler_inputs"] = {}
    for name, s in [
            ("neighbor (GraphSAGE)", SA.NeighborSampler(g, [5, 5], seed=0)),
            ("layer-wise (FastGCN)",
             SA.LayerWiseSampler(g, [64, 64], dependent=False, seed=0)),
            ("layer-dep (LADIES)",
             SA.LayerWiseSampler(g, [64, 64], dependent=True, seed=0))]:
        mb = s.sample(seeds)
        n_in = int((mb.blocks[0].src_nodes >= 0).sum())
        out["sampler_inputs"][name] = n_in
        print(f"sampler {name:22s}: {n_in:4d} input nodes "
              f"(full 2-hop = {full})")

    # --- caching (survey §3.2.4, PaGraph) ----------------------------------
    s = SA.NeighborSampler(g, [5, 5], seed=0)
    rng = np.random.default_rng(0)
    batches = [s.sample(rng.choice(g.num_nodes, 32, replace=False))
               .input_nodes for _ in range(10)]
    out["cache_hit_ratio"] = {}
    for policy in ("random", "degree"):
        r = CA.measure_cache(g, policy, g.num_nodes // 10, batches)
        out["cache_hit_ratio"][policy] = r["hit_ratio"]
        print(f"cache {policy:7s}: hit ratio {r['hit_ratio']:.1%}")

    # --- train a GCN through the SAGA-NN abstraction (§3.2.3) --------------
    cfg = GNNConfig(arch="gcn", feat_dim=32, hidden=64, num_classes=4)
    params = GM.init_gnn(cfg, torch.Generator().manual_seed(0), device=dev)
    step = GM.make_fullgraph_train_step(
        cfg, AdamW(params.parameters(), lr=1e-2, weight_decay=0.0))
    dg = DeviceGraph.from_graph(g, dev, src_layout=True)
    x = torch.from_numpy(g.features).to(dev)
    y = torch.from_numpy(g.labels).to(dev)
    mask = torch.ones(y.shape, dtype=torch.float32, device=dev)
    for _ in range(30):
        loss = step(params, dg, x, y, mask)
    with torch.no_grad():
        acc = float(GM.accuracy(GM.forward_full(cfg, params, dg, x), y))
    out.update(loss=float(loss), accuracy=acc)
    print(f"GCN after 30 epochs: loss {float(loss):.4f}, accuracy "
          f"{acc:.1%}")
    if acc <= 0.9:
        raise RuntimeError(f"quickstart: GCN accuracy {acc:.3f} <= 0.9")
    print("quickstart OK")
    return out


if __name__ == "__main__":
    main()
