"""GNN training driver (PyTorch port, one device).

Two of the reference's paths, on the device ``--device`` names (``cuda``
by default, where every aggregation and its backward run through the
hand-written Hopper kernels):

* **full-batch** (NeuGraph/ROC style, any architecture): the whole graph
  is one ``DeviceGraph`` with its dst- and src-grouped layouts, and each
  epoch is one AdamW step;
* **single-device mini-batch** (``--minibatch``, DistDGL style): the
  ``--sampler`` (``neighbor`` or PinSage-style ``importance``, fanouts 5,
  5; ``fastgcn`` or ``ladies``, 128 nodes a layer) in two
  ``PipelinedLoader`` threads, a ``FeatureStore`` with the ``--cache``
  policy over the wire codec ``--wire-codec``; under ``int8
  --use-kernel`` the input rows stay in the wire format into SAGE's
  layer-0 aggregation (the int8-in kernel), and under ``int8`` alone they
  are decoded on the host, as in the reference.

The graph is an SBM sized by ``--nodes`` or a ``--dataset`` of the
synthetic registry; ``--reorder`` packs it by a locality policy before
anything is built on it.

  PYTHONPATH=src python -m repro_torch.launch.train_gnn --arch gcn \\
      --nodes 512 --epochs 30 --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train_gnn --minibatch \\
      --sampler neighbor --cache degree --wire-codec int8 --use-kernel \\
      --epochs 2
  PYTHONPATH=src python -m repro_torch.launch.train_gnn --arch sage \\
      --dataset pubmed-like --reorder rcm --epochs 30

The flags of the reference's other paths are refused, with the
ROADMAP.md item that ports them, whenever they are set away from their
defaults.  ``--use-kernel`` is refused where all it would choose is the
kernels: the device chooses them (CUDA tensors run the Hopper kernels,
CPU tensors their plain versions).  None is silently ignored.
"""
from __future__ import annotations

import argparse
import sys
import time

# flag -> (is it set?, the ROADMAP.md item that ports it)
_NOT_PORTED = {
    "--devices > 1": (lambda a: a.devices > 1,
                      "Queue 1, distributed paths"),
    "--fullgraph": (lambda a: a.fullgraph, "Queue 1, distributed paths"),
    # the reference reads the stream only under --fullgraph (continual
    # training folds deltas through the async trainer's ghost buffers)
    "--update-stream": (lambda a: bool(a.update_stream),
                        "Queue 1, distributed paths"),
    "--sampler cluster|saint": (
        lambda a: a.minibatch and a.sampler in ("cluster", "saint"),
        "Queue 1, launch/train_gnn.py: the other samplers; the reference "
        "builds no sampler for them (train_gnn.py:412-413: sampler = "
        "None) and its loader thread dies on sampler.sample with "
        "AttributeError (Queue 3)"),
    "--partitioner / --mode / --staleness / --refresh-frac": (
        lambda a: (a.partitioner, a.mode, a.staleness, a.refresh_frac)
        != ("hash", "pull", 4, 0.0), "Queue 1, distributed paths"),
    "--updates-per-epoch": (lambda a: a.updates_per_epoch != 0,
                            "Queue 1, distributed paths"),
}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=1,
                    help="devices (> 1 not ported yet: refused)")
    ap.add_argument("--nodes", type=int, default=512)
    ap.add_argument("--avg-degree", type=float, default=8.0)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--feat-dim", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--arch", default="gcn",
                    choices=["gcn", "sage", "gat", "gin", "ggnn", "appnp"])
    ap.add_argument("--dataset", default="",
                    help="named dataset from repro_torch.graph.datasets "
                         "(its graph, features and classes replace "
                         "--nodes/--classes/--feat-dim); default: an SBM "
                         "sized by --nodes")
    ap.add_argument("--partitioner", default="hash",
                    choices=["hash", "ldg", "fennel", "auto"],
                    help="edge-cut partitioner of the distributed paths "
                         "(not ported yet: refused unless hash)")
    ap.add_argument("--mode", default="pull",
                    choices=["pull", "push", "stale", "hysync"],
                    help="distributed full-graph mode (not ported yet: "
                         "refused unless pull)")
    ap.add_argument("--staleness", type=int, default=4,
                    help="staleness bound of the distributed paths (not "
                         "ported yet: refused unless 4)")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--minibatch", action="store_true")
    ap.add_argument("--fullgraph", action="store_true",
                    help="asynchronous full-graph training (not ported "
                         "yet: refused)")
    ap.add_argument("--refresh-frac", type=float, default=0.0,
                    help="asynchronous full-graph refresh fraction (not "
                         "ported yet: refused unless 0)")
    ap.add_argument("--update-stream", default="",
                    help="graph-update stream of continual --fullgraph "
                         "training (not ported yet: refused)")
    ap.add_argument("--updates-per-epoch", type=int, default=0,
                    help="graph updates per epoch of continual "
                         "--fullgraph training (not ported yet: refused "
                         "unless 0)")
    ap.add_argument("--sampler", default="neighbor",
                    choices=["neighbor", "importance", "fastgcn", "ladies",
                             "cluster", "saint"],
                    help="mini-batch sampler: neighbor and importance "
                         "(fanouts 5, 5), fastgcn and ladies (128 nodes "
                         "a layer); cluster and saint are refused")
    ap.add_argument("--cache", default="degree",
                    choices=["none", "degree", "importance", "random"])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reorder", default="none",
                    choices=["none", "degree", "bfs", "rcm"],
                    help="locality-reorder the graph (survey §3.2.4) "
                         "before anything is built on it; training is "
                         "invariant under the relabelling")
    ap.add_argument("--use-kernel", action="store_true",
                    help="with --minibatch --wire-codec int8: keep the "
                         "input rows in the wire format into the int8-in "
                         "aggregation; refused elsewhere, where the device "
                         "chooses the kernels")
    ap.add_argument("--wire-codec", default="fp32",
                    choices=["fp32", "bf16", "int8"],
                    help="communication-plane wire codec "
                         "(repro_torch.core.comm) for the mini-batch "
                         "trainer's feature fetches; fp32 is bit-exact")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; raises "
                         "when CUDA is missing)")
    ap.add_argument("--metrics-out", default="",
                    help="enable telemetry and write the Prometheus "
                         "text-format exposition here on exit "
                         "(repro_torch.core.telemetry)")
    ap.add_argument("--trace-out", default="",
                    help="enable telemetry and write the JSONL span "
                         "trace here on exit")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for flag, (is_set, item) in _NOT_PORTED.items():
        if is_set(args):
            raise SystemExit(
                f"train_gnn: {flag} is not ported to repro_torch yet; "
                f"see ROADMAP.md, {item}")
    if args.use_kernel and not (args.minibatch
                                and args.wire_codec == "int8"):
        raise SystemExit(
            "train_gnn: --use-kernel only selects the int8-in path of "
            "--minibatch --wire-codec int8; elsewhere the device chooses "
            "the kernels (cuda runs the Hopper kernels, cpu their plain "
            "versions)")
    return args


def main(argv=None):
    """Parse args, train, and (when asked) dump the telemetry plane on
    exit — metrics as Prometheus text, spans as JSONL."""
    args = parse_args(argv)
    from repro_torch.core import telemetry
    if args.metrics_out or args.trace_out:
        telemetry.set_enabled(True)
    try:
        return run(args)
    finally:
        if args.metrics_out:
            telemetry.get_registry().write_prometheus(args.metrics_out)
            print(f"telemetry: metrics -> {args.metrics_out}")
        if args.trace_out:
            n = telemetry.get_registry().tracer.export_jsonl(args.trace_out)
            print(f"telemetry: {n} trace events -> {args.trace_out}")


def run(args) -> dict:
    """The training driver; ``main`` wraps it with the telemetry dump.
    Returns a summary: the per-epoch (full-batch) or per-step
    (mini-batch) losses, wall times, the trained ``model`` and the
    host ``graph`` it trained on."""
    if args.wire_codec != "fp32" and not args.minibatch:
        # the full-batch trainer is not on the communication plane;
        # silently ignoring the flag would make its traffic a lie
        raise SystemExit("--wire-codec is wired through --fullgraph and "
                         "--minibatch; the synchronous full-graph modes "
                         "move raw fp32")

    import numpy as np
    import torch

    from repro_torch import device as D
    from repro_torch.models.gnn import model as GM
    from repro_torch.models.gnn.model import GNNConfig
    from repro_torch.optim import AdamW

    device = D.resolve(args.device)
    rng = np.random.default_rng(args.seed)
    g = load_graph(args)
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges, "
          f"{g.num_classes} classes; device={device}")
    # pack BEFORE anything is built on the graph (layouts, samplers,
    # caches), so every structure keys off the packed id space; training
    # is invariant under the relabelling, so perm only serves reporting
    g, reorder = reorder_for_launch(g, args.reorder)

    cfg = GNNConfig(arch=args.arch, feat_dim=g.features.shape[1],
                    hidden=args.hidden, num_classes=g.num_classes,
                    use_kernel=args.use_kernel, wire_codec=args.wire_codec)
    model = GM.init_gnn(cfg, torch.Generator().manual_seed(args.seed),
                        device=device)
    opt = AdamW(model.parameters(), lr=args.lr, weight_decay=0.0)
    if args.minibatch:
        out = _minibatch(args, g, cfg, model, opt, rng, device)
    else:
        out = _fullbatch(args, g, cfg, model, opt, device)
    out["reorder"] = reorder
    return out


def load_graph(args):
    """The launch's host graph: the ``--dataset`` registry entry, or an
    SBM of ``--nodes`` nodes and ``--classes`` classes with
    ``--feat-dim`` features (both launchers make it so)."""
    from repro_torch.graph import generators as G
    if args.dataset:
        from repro_torch.graph.datasets import load
        return load(args.dataset, seed=args.seed).graph
    g = G.sbm(args.nodes, args.classes, p_in=0.9, p_out=0.02,
              seed=args.seed)
    return G.featurize(g, args.feat_dim, seed=args.seed, class_sep=1.5)


def reorder_for_launch(g, policy: str):
    """``g`` packed by ``policy`` (``none`` returns it as it is), and what
    the launch reports of it: the policy, the host seconds the packing
    took, its ``locality_report`` and ``(perm, inv)``."""
    from repro_torch.core.reordering import locality_report
    t0 = time.perf_counter()
    g, perm, inv = g.reordered(policy)
    info = {"policy": policy, "seconds": time.perf_counter() - t0,
            "perm": perm, "inv": inv}
    if policy != "none":
        info["locality"] = locality_report(g)
        print(f"reorder={policy} ({info['seconds']:.2f} s): gather stride "
              f"{info['locality']['avg_gather_stride']:.1f}, reuse hit "
              f"{info['locality']['reuse_hit_rate']:.2%}, edge locality "
              f"{info['locality']['edge_locality']:.2%}")
    return g, info


def _sync(device) -> None:
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)


def _fullbatch(args, g, cfg, model, opt, device) -> dict:
    """The generic single-device full-batch trainer (any architecture)."""
    import torch

    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.models.gnn import model as GM
    t0 = time.perf_counter()
    dg = DeviceGraph.from_graph(g, device, src_layout=True)
    x = torch.from_numpy(g.features).to(device)
    y = torch.from_numpy(g.labels).to(device)
    mask = torch.ones(y.shape, dtype=torch.float32, device=device)
    _sync(device)
    setup_s = time.perf_counter() - t0
    step = GM.make_fullgraph_train_step(cfg, opt)
    losses, epoch_s = [], []
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        loss = float(step(model, dg, x, y, mask))    # waits for the step
        epoch_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if epoch % 5 == 0 or epoch == args.epochs - 1:
            print(f"epoch {epoch:3d} loss {loss:.4f}")
    with torch.no_grad():
        acc = float(GM.accuracy(GM.forward_full(cfg, model, dg, x), y))
    print(f"final accuracy {acc:.3f}")
    return {"mode": "fullbatch", "losses": losses, "epoch_s": epoch_s,
            "setup_s": setup_s, "accuracy": acc, "model": model, "graph": g}


def _minibatch(args, g, cfg, model, opt, rng, device) -> dict:
    """The single-device mini-batch trainer."""
    import numpy as np
    import torch

    from repro_torch.core import caching as CA
    from repro_torch.core import sampling as SA
    from repro_torch.core import telemetry
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.core.scheduling import PipelinedLoader
    from repro_torch.models.gnn import model as GM

    if args.sampler == "neighbor":
        sampler = SA.NeighborSampler(g, [5, 5], seed=args.seed)
    elif args.sampler == "importance":
        sampler = SA.ImportanceSampler(g, [5, 5], seed=args.seed)
    else:                                      # fastgcn | ladies
        sampler = SA.LayerWiseSampler(g, [128, 128],
                                      dependent=args.sampler == "ladies",
                                      seed=args.seed)
    cache_ids = CA.CACHE_POLICIES[args.cache](g, g.num_nodes // 10)
    store = CA.FeatureStore(g, cache_ids, codec=args.wire_codec)
    step = GM.make_minibatch_train_step(cfg, opt)

    def make_batch():
        seeds = rng.choice(g.num_nodes, args.batch, replace=False)
        mb = sampler.sample(seeds)
        return mb, seeds

    loader = PipelinedLoader(make_batch, depth=4, n_workers=2)
    steps_per_epoch = max(1, g.num_nodes // args.batch)
    losses, step_s = [], []
    m_step = telemetry.histogram(
        "train_step_seconds", "wall time per executed training step",
        mode="minibatch_single")
    try:
        for epoch in range(args.epochs):
            for _ in range(steps_per_epoch):
                mb, seeds = next(loader)
                t0 = time.perf_counter()
                with telemetry.span("train.step", mode="minibatch_single"):
                    # both layouts of every block are built on the host
                    # here, inside the step
                    blocks = [DeviceGraph.from_block(b, device,
                                                     src_layout=True)
                              for b in mb.blocks]
                    # input rows travel the communication plane: cache
                    # misses are byte-accounted; under int8 --use-kernel
                    # they stay in the wire format into the int8-in
                    # aggregation, else they arrive decoded
                    src = mb.blocks[0].src_nodes
                    if args.wire_codec == "int8" and args.use_kernel:
                        x_in = store.fetch_masked_wire(src, src >= 0)
                    else:
                        x_in = torch.from_numpy(
                            store.fetch_masked(src, src >= 0)).to(device)
                    y = torch.from_numpy(g.labels[seeds]).to(device)
                    loss = step(model, blocks, x_in, y,
                                torch.ones(y.shape, dtype=torch.float32,
                                           device=device))
                    losses.append(float(loss))      # waits for the step
                step_s.append(time.perf_counter() - t0)
                m_step.observe(step_s[-1])
            print(f"epoch {epoch:3d} loss {losses[-1]:.4f} "
                  f"cache_hit {store.hit_ratio:.2%} "
                  f"fetched {store.transferred_bytes / 2**20:.1f} MiB")
    finally:
        loader.close()
    return {"mode": "minibatch_single", "losses": losses, "step_s": step_s,
            "cache_hit_ratio": store.hit_ratio,
            "fetched_bytes": store.transferred_bytes,
            "steps": len(losses), "model": model, "graph": g}


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
