"""Online GNN serving walkthrough (the reference's ``examples/serve_gnn.py``
on the port's serving stack).

Builds a community graph, stands up a small GraphSAGE model behind
:class:`repro_torch.serving.GNNInferenceServer`, and walks through what
each piece does: bucketed micro-batching, fixed-shape sampling, and the
historical-embedding cache under a feature update.

  PYTHONPATH=src python -m repro_torch.examples.serve_gnn [--device cpu]
"""
from __future__ import annotations

import argparse
import copy

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.graph import generators as G
from repro_torch.models.gnn import model as GM
from repro_torch.models.gnn.model import GNNConfig
from repro_torch.serving import GNNInferenceServer, poisson_workload
from repro_torch.serving.batcher import BucketedBatcher
from repro_torch.serving.request import InferenceRequest, RequestQueue


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises when CUDA is "
                         "missing)")
    args = ap.parse_args(argv)
    dev = D.resolve(args.device)

    # --- a served model -----------------------------------------------------
    g = G.sbm(600, 4, p_in=0.9, p_out=0.02, seed=0)
    g = G.featurize(g, 32, seed=0, class_sep=1.5)
    cfg = GNNConfig(arch="sage", feat_dim=32, hidden=64, num_classes=4)
    params = GM.init_gnn(cfg, torch.Generator().manual_seed(0), device=dev)
    print(f"graph: {g.num_nodes} nodes / {g.num_edges} edges; model: "
          f"{cfg.arch} x{cfg.num_layers} on {dev}")

    # --- 1. the batcher pads to declared buckets ----------------------------
    batcher = BucketedBatcher(buckets=(1, 4, 16), max_wait_s=0.002)
    q = RequestQueue()
    for i in range(6):
        q.push(InferenceRequest(i, i * 7, arrival_s=0.0))
    mb = batcher.form(q, now=0.01)
    print(f"6 pending requests -> bucket {mb.bucket} "
          f"(fill {mb.fill:.0%}, ids {mb.node_ids.tolist()})")

    # --- 2. the server ties sampling + caching + forward together -----------
    srv = GNNInferenceServer(g, cfg, params, fanouts=(5, 5),
                             buckets=(1, 4, 16), cache_policy="degree",
                             cache_capacity=g.num_nodes // 5, seed=0)
    srv.warmup()                      # one forward shape a bucket
    wl = poisson_workload(128, np.arange(g.num_nodes), rate_rps=3000.0,
                          seed=1)
    stats = srv.run(copy.deepcopy(wl))
    s = srv.summary()
    print(f"served {s['served']} requests in {stats.batches} batches: "
          f"{s['throughput_rps']:.0f} req/s, p50 {s['p50_ms']:.2f} ms, "
          f"p99 {s['p99_ms']:.2f} ms")
    print(f"embedding hit rate {s['embedding_hit_ratio']:.1%}, "
          f"feature bytes {s['feature_bytes'] / 2**10:.0f} KiB, "
          f"forward shapes {s['jit_entries']} (== #buckets used)")

    # --- 3. feature updates invalidate cached embeddings --------------------
    hot = int(np.argmax(g.out_degree()))
    before = srv.cache.lookup(0, np.asarray([hot]))[1][0]
    srv.cache.update_features(np.asarray([hot]),
                              g.features[hot][None] + 0.1)
    after = srv.cache.lookup(0, np.asarray([hot]))[1][0]
    print(f"hot node {hot}: cached before update={bool(before)}, "
          f"after update={bool(after)} (entry invalidated)")
    print("serve_gnn example OK")
    return dict(s, hot_cached_before=bool(before),
                hot_cached_after=bool(after))


if __name__ == "__main__":
    main()
