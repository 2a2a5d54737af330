"""The port's side of the distributed tests: rank functions that
``repro_torch.launch.train_gnn.run_world`` runs in every spawned rank (as
``functools.partial`` jobs), on the graph and sizes of
``tests/torch_dist_reference.py``.  Imports torch and the port only, so a
rank starts without JAX.  Each returns the rank's losses and final
parameters as numpy."""
import dataclasses

import numpy as np
import torch

from repro_torch.core import collectives as C
from repro_torch.core import coordination
from repro_torch.core import propagation as PR
from repro_torch.core.updates import synthesize_updates
from repro_torch.graph import generators as G
from repro_torch.models.gnn import model as GM
from repro_torch.optim import AdamW, Sgd

STEPS = 10
CFG = dict(arch="gcn", feat_dim=16, hidden=32, num_classes=4)
OPTS = {"adamw": lambda ps: AdamW(ps, lr=1e-2, weight_decay=0.0),
        "sgd": lambda ps: Sgd(ps, lr=0.1)}


def graph():
    g = G.sbm(144, 4, p_in=0.9, p_out=0.02, seed=0)
    return G.featurize(g, 16, seed=0, class_sep=1.5)


def params_np(model) -> list:
    return [{k: v.detach().cpu().numpy() for k, v in layer.named_parameters()}
            for layer in model]


def _model(params0, dev, **kw):
    cfg = GM.GNNConfig(**CFG, **kw)
    return cfg, GM.params_from_numpy(cfg, params0, device=dev)


def sync_run(rank, world, dev, *, mode, params0, opt="adamw"):
    """``STEPS`` steps of a synchronous mode (``propagation.run_sync``,
    the launcher's driver; stale reads the input features as its
    halo)."""
    g = graph()
    sg = PR.shard_graph(g, world, method="hash")
    _, model = _model(params0, dev)
    out = PR.run_sync(model, OPTS[opt](model.parameters()), sg, g, rank,
                      dev, mode=mode, steps=STEPS)
    return {"losses": out["losses"], "params": params_np(model)}


def async_run(rank, world, dev, *, staleness, params0, refresh_frac=0.05,
              codec="fp32"):
    """``STEPS`` epochs of the asynchronous trainer."""
    from repro_torch.distributed import AsyncFullGraphTrainer
    cfg, model = _model(params0, dev, wire_codec=codec)
    tr = AsyncFullGraphTrainer(graph(), cfg, OPTS["adamw"](
        model.parameters()), world, staleness=staleness,
        refresh_frac=refresh_frac, device=dev)
    tr.run(model, STEPS)
    return {"losses": tr.losses, "params": params_np(model),
            "stats": tr.stats(), "ghost_digest": tr.ghost_digest()}


def fold_run(rank, world, dev, *, params0, events=40, fold=20):
    """Three 1-epoch runs of the asynchronous trainer (S 2) with a
    synthesized stream folded ``fold`` events at a time between them."""
    from repro_torch.distributed import AsyncFullGraphTrainer
    g = graph()
    log = synthesize_updates(g, events, seed=1)
    cfg, model = _model(params0, dev)
    tr = AsyncFullGraphTrainer(dataclasses.replace(g), cfg, OPTS["adamw"](
        model.parameters()), world, staleness=2, refresh_frac=0.05,
        device=dev)
    folds = []
    for _ in range(3):
        tr.run(model, 1)
        if tr._update_seq < log.last_seq:
            f = tr.fold_updates(log, tr._update_seq + fold)
            folds.append([f["events"], f["touched_nodes"],
                          f["invalidated_rows"], f["upto_seq"]])
    return {"folds": folds, "params": params_np(model),
            "versions": np.stack([b.version for b in tr.exchange.buffers])}


def coordination_run(rank, world, dev):
    """Both coordinators on the same per-rank gradients (every rank's its
    own), three AdamW steps each from the same parameters: the largest
    difference of the parameters."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(16, 32), (32,), (32, 4), (4,)]
    init = [torch.randn(s, generator=gen) for s in shapes]
    grads = [[torch.randn(s, generator=gen) * (1 + q) for s in shapes]
             for q in range(world)][rank]
    out = {}
    for name, fn in coordination.COORDINATORS.items():
        ps = [torch.nn.Parameter(t.clone().to(dev)) for t in init]
        opt = AdamW(ps, lr=1e-2, weight_decay=0.0)
        for _ in range(3):
            fn(opt, ps, [g.to(dev) for g in grads])
        out[name] = [p.detach().cpu().numpy() for p in ps]
    diff = max(float(np.abs(a - b).max()) for a, b in
               zip(out["decentralized"], out["parameter_server"]))
    return {"max_diff": diff, "comm": C.STATS.snapshot(),
            "params": out["decentralized"]}
