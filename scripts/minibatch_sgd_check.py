"""Single-device mini-batch SGD at Reddit's widths, as phase 14(g) of
``chip_smoke.py`` runs it on its single card: the SBM at 232 965 nodes,
602 features, hidden 256, a one-partition ``DistributedMinibatchSampler``
without a cache, 10 global batches of 1024 seeds (``--seed 0``),
``make_minibatch_train_step`` over ``device_blocks``.  For each ``--lr``
it prints the losses of the float32 run and the largest parameter
difference from the same run with float64 gradients (the kernels' plain
versions; the optimizer updates in float32, as the reference's does).

    PYTHONPATH=src python scripts/minibatch_sgd_check.py --arch gin \\
        --lr 0.1 0.01 --device cpu

Builds the graph on the host (~10 s, ~1 GB); on a card the float32 run
takes the kernels.
"""
import argparse
import json

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.distributed import DistributedMinibatchSampler, device_blocks
from repro_torch.graph import generators as G
from repro_torch.kernels import segment_sum
from repro_torch.models.gnn import model as GM
from repro_torch.optim import Sgd


def run(arch, classes, lr, batches, ds, dev, dtype):
    cfg = GM.GNNConfig(arch=arch, feat_dim=602, hidden=256,
                       num_classes=classes)
    model = GM.init_gnn(cfg, torch.Generator().manual_seed(0),
                        device=dev).to(dtype)
    step = GM.make_minibatch_train_step(cfg, Sgd(model.parameters(), lr=lr))
    losses = []
    for b in batches:
        blocks = device_blocks(b, ds.out_deg, dev)
        for bl in blocks:
            bl.in_deg, bl.out_deg = bl.in_deg.to(dtype), bl.out_deg.to(dtype)
        losses.append(float(step(
            model, blocks, torch.from_numpy(b.x_in).to(dev, dtype),
            torch.from_numpy(b.labels).to(dev),
            torch.from_numpy(b.label_mask).to(dev, dtype))))
    return losses, [p.detach().double().cpu() for p in model.parameters()]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gin")
    ap.add_argument("--classes", type=int, default=41)
    ap.add_argument("--lr", type=float, nargs="+", default=[0.1, 0.01])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = D.resolve(args.device)
    g = G.featurize(G.sbm(232965, args.classes, p_in=0.9, p_out=0.02,
                          seed=0), 602, seed=0, class_sep=1.5)
    ds = DistributedMinibatchSampler(g, 1, [5, 5], 1024,
                                     cache_policy="none", seed=0)
    rng = np.random.default_rng(0)
    batches = [ds.sample_global(rng.choice(g.num_nodes, 1024,
                                           replace=False))[0]
               for _ in range(10)]
    for lr in args.lr:
        losses, p32 = run(args.arch, args.classes, lr, batches, ds, dev,
                          torch.float32)
        pick = segment_sum.pick
        segment_sum.pick = lambda cuda_fn, plain_fn, t: plain_fn
        try:
            _, p64 = run(args.arch, args.classes, lr, batches, ds, dev,
                         torch.float64)
        finally:
            segment_sum.pick = pick
        print(json.dumps({
            "arch": args.arch, "lr": lr, "device": str(dev),
            "losses": losses,
            "float32_vs_float64": max(float((a - b).abs().max())
                                      for a, b in zip(p32, p64))}),
              flush=True)


if __name__ == "__main__":
    main()
