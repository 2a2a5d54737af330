"""GNN training driver (PyTorch port).

The reference's paths, on the device ``--device`` names (``cuda`` by
default, where every aggregation and its backward run through the
hand-written Hopper kernels):

* **full-batch** (NeuGraph/ROC style, any architecture, one device): the
  whole graph is one ``DeviceGraph`` with its dst- and src-grouped
  layouts, and each epoch is one AdamW step;
* **distributed full-graph** (``--devices N``, GCN): the graph is cut by
  the edge-cut ``--partitioner`` (``auto`` asks
  ``partitioning.select_partitioner``) into N rank shards, and each
  epoch is one step of every rank under ``--mode``: ``pull``
  (all-gather features), ``push`` (reduce-scatter partial aggregates),
  ``stale`` (DistGNN's delayed layer-0 halo, refreshed every
  ``--staleness`` epochs) or ``hysync`` (stale until progress slows,
  then synchronous);
* **asynchronous full-graph** (``--fullgraph``, GCN, any ``--devices``):
  per-layer versioned ghost buffers, a ``--staleness`` age bound, a
  ``--refresh-frac`` budget and the in-step ``--wire-codec``; with
  ``--update-stream`` a JSONL graph-update stream is folded into the
  training graph between epochs (``--updates-per-epoch`` events, or the
  stream spread evenly over the run);
* **single-device mini-batch** (``--minibatch``, DistDGL style): the
  ``--sampler`` (``neighbor`` or PinSage-style ``importance``, fanouts 5,
  5; ``fastgcn`` or ``ladies``, 128 nodes a layer) in two
  ``PipelinedLoader`` threads, a ``FeatureStore`` with the ``--cache``
  policy over the wire codec ``--wire-codec``; under ``int8
  --use-kernel`` the input rows stay in the wire format into SAGE's
  layer-0 aggregation (the int8-in kernel), and under ``int8`` alone they
  are decoded on the host, as in the reference;
* **distributed mini-batch** (``--devices N --minibatch``, the
  DistDGL/PaGraph partition-parallel recipe, any architecture the block
  forward takes): the ``--partitioner`` cuts the graph into N
  partitions, every rank draws the same global seed batch and samples
  the seeds it owns with the padded neighbor sampler (fanouts 5, 5),
  fetching remote rows through its partition's halo cache (``--cache``,
  a tenth of the nodes) over ``--wire-codec`` (rows arrive decoded, as
  the reference's ``collate`` gives them); one step a rank all-reduces
  the gradients (:mod:`repro_torch.distributed`).

The distributed paths spawn exactly ``--devices`` ranks with
``torch.multiprocessing`` (spawn, never fork), one process a rank, joined
in a gloo group through a file store (:mod:`repro_torch.core.collectives`;
CUDA tensors are staged through pinned host buffers).  Rank ``r`` runs on
``cuda:(r % device_count)``, so N ranks share one card when there is one;
``--device cpu`` puts every rank on the CPU.  A rank that fails makes the
launch fail; every collective has a timeout, so no rank waits for a dead
one forever.

The graph is an SBM sized by ``--nodes`` or a ``--dataset`` of the
synthetic registry; ``--reorder`` packs it by a locality policy before
anything is built on it.

  PYTHONPATH=src python -m repro_torch.launch.train_gnn --arch gcn \\
      --nodes 512 --epochs 30 --device cuda
  PYTHONPATH=src python -m repro_torch.launch.train_gnn --devices 4 \\
      --partitioner ldg --mode pull --epochs 30
  PYTHONPATH=src python -m repro_torch.launch.train_gnn --fullgraph \\
      --devices 4 --staleness 2 --refresh-frac 0.05 --wire-codec int8
  PYTHONPATH=src python -m repro_torch.launch.train_gnn --minibatch \\
      --sampler neighbor --cache degree --wire-codec int8 --use-kernel \\
      --epochs 2
  PYTHONPATH=src python -m repro_torch.launch.train_gnn --minibatch \\
      --devices 4 --arch sage --batch 1024 --wire-codec int8 --epochs 2

Refused, with the reason (none is silently ignored): ``--sampler
cluster|saint``, another ``--sampler`` than ``neighbor`` on the
distributed mini-batch path, a distributed full-graph run of another
architecture than GCN (the reference trains those on one device while
told to use N), and every flag set away from its default on a path that
does not read it.  ``--use-kernel`` is refused where all it would choose
is the kernels: the device chooses them (CUDA tensors run the Hopper
kernels, CPU tensors their plain versions).
"""
from __future__ import annotations

import argparse
import math
import os
import pickle
import shutil
import sys
import tempfile
import time

#: seconds a distributed launch may run before its ranks are killed
WORLD_TIMEOUT_S = 3600.0

# flag -> (is it refused?, why)
_REFUSED = {
    "--sampler cluster|saint": (
        lambda a: a.minibatch and a.sampler in ("cluster", "saint"),
        "refused: the reference builds no sampler for them "
        "(train_gnn.py:412-413: sampler = None) and its loader thread "
        "dies on sampler.sample with AttributeError, so its trainer hangs; "
        "see ROADMAP.md, Queue 3"),
    "--devices > 1 --minibatch --sampler": (
        lambda a: a.devices > 1 and a.minibatch and a.sampler != "neighbor",
        "distributed mini-batch uses the padded neighbor sampler "
        "(--sampler neighbor)"),
    "--devices > 1 with another architecture than gcn": (
        lambda a: a.devices > 1 and not a.minibatch and a.arch != "gcn",
        "distributed full-graph mode implements GCN; use --minibatch for "
        "other architectures (distributed mini-batch with --devices N)"),
    "--fullgraph with another architecture than gcn": (
        lambda a: a.fullgraph and a.arch != "gcn",
        "--fullgraph implements GCN (like the synchronous distributed "
        "full-graph mode)"),
    "--fullgraph --minibatch": (
        lambda a: a.fullgraph and a.minibatch,
        "--fullgraph and --minibatch are two different trainers"),
    "--update-stream": (
        lambda a: bool(a.update_stream) and not a.fullgraph,
        "--update-stream requires --fullgraph (continual training folds "
        "deltas through the async trainer's versioned ghost buffers)"),
    "--updates-per-epoch": (
        lambda a: a.updates_per_epoch != 0 and not a.update_stream,
        "--updates-per-epoch is read only with --update-stream"),
    "--partitioner": (
        lambda a: a.partitioner != "hash" and not _spawned(a),
        "--partitioner is read only by the distributed paths "
        "(--devices > 1 or --fullgraph)"),
    "--mode": (
        lambda a: a.mode != "pull" and not (_sharded(a) and not a.fullgraph),
        "--mode is read only by the synchronous distributed full-graph "
        "path (--devices > 1 without --fullgraph)"),
    "--staleness": (
        lambda a: a.staleness != 4 and not (
            a.fullgraph or (_sharded(a) and a.mode in ("stale", "hysync"))),
        "--staleness is read only by --mode stale|hysync and --fullgraph"),
    "--refresh-frac": (
        lambda a: a.refresh_frac != 0.0 and not a.fullgraph,
        "--refresh-frac is read only by --fullgraph"),
}


def _sharded(a) -> bool:
    """Whether ``a`` asks for a distributed full-graph run."""
    return a.fullgraph or (a.devices > 1 and not a.minibatch)


def _spawned(a) -> bool:
    """Whether ``a`` asks for a distributed run (spawned ranks): the
    full-graph paths or the distributed mini-batch path."""
    return a.fullgraph or a.devices > 1


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks of the distributed paths "
                         "(spawned processes; rank r on cuda:(r % "
                         "device_count), or all on the CPU under "
                         "--device cpu)")
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
                    help="edge-cut partitioner of the distributed "
                         "paths (auto: EASE-style selection)")
    ap.add_argument("--mode", default="pull",
                    choices=["pull", "push", "stale", "hysync"],
                    help="synchronous distributed full-graph mode")
    ap.add_argument("--staleness", type=int, default=4,
                    help="staleness bound S: full-epoch snapshot period "
                         "for --mode stale/hysync, per-row ghost age bound "
                         "for --fullgraph")
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--minibatch", action="store_true")
    ap.add_argument("--fullgraph", action="store_true",
                    help="staleness-bounded asynchronous full-graph "
                         "training (repro_torch.distributed.async_train)")
    ap.add_argument("--refresh-frac", type=float, default=0.0,
                    help="extra per-step ghost refresh budget as a "
                         "fraction of the ghost set (--fullgraph only)")
    ap.add_argument("--update-stream", default="",
                    help="continual training: a JSONL graph-update stream "
                         "(repro_torch.core.updates) folded into the "
                         "training graph between epochs (--fullgraph "
                         "only)")
    ap.add_argument("--updates-per-epoch", type=int, default=0,
                    help="events folded between consecutive epochs (0 = "
                         "spread the whole stream evenly across the run)")
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
                         "(repro_torch.core.comm): the mini-batch "
                         "trainer's feature fetches and --fullgraph's "
                         "ghost refreshes; fp32 is bit-exact")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; raises "
                         "when CUDA is missing)")
    ap.add_argument("--metrics-out", default="",
                    help="enable telemetry and write the Prometheus "
                         "text-format exposition here on exit "
                         "(repro_torch.core.telemetry; rank 0's in a "
                         "distributed run)")
    ap.add_argument("--trace-out", default="",
                    help="enable telemetry and write the JSONL span "
                         "trace here on exit")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    for flag, (refused, why) in _REFUSED.items():
        if refused(args):
            raise SystemExit(f"train_gnn: {flag}: {why}")
    if args.wire_codec != "fp32" and not (args.minibatch or args.fullgraph):
        # the synchronous full-graph modes and the full-batch trainer are
        # not on the communication plane; silently ignoring the flag
        # would make their reported traffic a lie
        raise SystemExit("--wire-codec is wired through --fullgraph and "
                         "--minibatch; the synchronous full-graph modes "
                         "move raw fp32")
    if args.use_kernel and not (args.minibatch and args.devices == 1
                                and args.wire_codec == "int8"):
        raise SystemExit(
            "train_gnn: --use-kernel only selects the int8-in path of "
            "--minibatch --wire-codec int8 on one device (the distributed "
            "mini-batch path decodes the rows, as the reference's collate "
            "does); elsewhere the device chooses the kernels (cuda runs "
            "the Hopper kernels, cpu their plain versions)")
    if args.devices < 1:
        raise SystemExit("train_gnn: --devices must be at least 1")
    return args


def main(argv=None):
    """Parse args, train, and (when asked) dump the telemetry plane on
    exit — metrics as Prometheus text, spans as JSONL.  A distributed
    run (``--devices > 1`` or ``--fullgraph``) spawns its ranks and
    returns :func:`run_world`'s summary of the job."""
    args = parse_args(argv)
    if _spawned(args):
        return run_world([args], world=args.devices, device=args.device)[0]
    return _with_telemetry(args, run)


def _with_telemetry(args, fn):
    from repro_torch.core import telemetry
    if args.metrics_out or args.trace_out:
        telemetry.set_enabled(True)
    try:
        return fn(args)
    finally:
        if args.metrics_out:
            telemetry.get_registry().write_prometheus(args.metrics_out)
            print(f"telemetry: metrics -> {args.metrics_out}")
        if args.trace_out:
            n = telemetry.get_registry().tracer.export_jsonl(args.trace_out)
            print(f"telemetry: {n} trace events -> {args.trace_out}")


def run(args, *, steps_per_epoch: int = 0) -> dict:
    """The single-device training driver; ``main`` wraps it with the
    telemetry dump.  ``steps_per_epoch`` cuts a mini-batch epoch short
    (0: ``nodes // batch`` steps, the reference's epoch).  Returns a
    summary: the per-epoch (full-batch) or per-step (mini-batch) losses,
    wall times, the trained ``model`` and the host ``graph`` it trained
    on."""
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
        out = _minibatch(args, g, cfg, model, opt, rng, device,
                         steps_per_epoch)
    else:
        out = _fullbatch(args, g, cfg, model, opt, device)
    out["reorder"] = reorder
    return out


# the host graphs a process has made, by what makes them: a process that
# launches several times on one graph (tests, chip_smoke.py, a notebook)
# makes it once.  Each launch gets a copy of the features, which the
# serving cache's update path writes in place; the structure is shared (an
# update stream replaces a graph's arrays, never writes into them)
_LOADED: dict = {}


def load_graph(args):
    """The launch's host graph: the ``--dataset`` registry entry, or an
    SBM of ``--nodes`` nodes and ``--classes`` classes with
    ``--feat-dim`` features (both launchers make it so), made once a
    process for each such tuple (``_LOADED``)."""
    import dataclasses
    key = (args.dataset, args.nodes, args.classes, args.feat_dim, args.seed)
    if key not in _LOADED:
        from repro_torch.graph import generators as G
        if args.dataset:
            from repro_torch.graph.datasets import load
            g = load(args.dataset, seed=args.seed).graph
        else:
            g = G.featurize(G.sbm(args.nodes, args.classes, p_in=0.9,
                                  p_out=0.02, seed=args.seed),
                            args.feat_dim, seed=args.seed, class_sep=1.5)
        _LOADED[key] = g
    g = _LOADED[key]
    return dataclasses.replace(
        g, features=None if g.features is None else g.features.copy())


def reorder_for_launch(g, policy: str, log=print):
    """``g`` packed by ``policy`` (``none`` returns it as it is), and what
    the launch reports of it: the policy, the host seconds the packing
    took, its ``locality_report`` and ``(perm, inv)``; ``log`` prints
    the report."""
    from repro_torch.core.reordering import locality_report
    t0 = time.perf_counter()
    g, perm, inv = g.reordered(policy)
    info = {"policy": policy, "seconds": time.perf_counter() - t0,
            "perm": perm, "inv": inv}
    if policy != "none":
        info["locality"] = locality_report(g)
        log(f"reorder={policy} ({info['seconds']:.2f} s): gather stride "
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


def _minibatch(args, g, cfg, model, opt, rng, device,
               steps_per_epoch: int = 0) -> dict:
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
    steps_per_epoch = steps_per_epoch or max(1, g.num_nodes // args.batch)
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



# ---------------------------------------------------------------------------
# the distributed paths: one spawned process a rank
# ---------------------------------------------------------------------------

def run_world(jobs, *, world: int, device: str = "cuda",
              timeout_s: float = WORLD_TIMEOUT_S) -> list:
    """Spawn ``world`` ranks once and run every job in turn inside that
    one world (a card's contexts and the group are paid for once).

    A job is an argv list or a parsed ``Namespace`` of a distributed run
    (its ``--devices`` must be ``world`` and its ``--device``
    ``device``), or a module-level callable ``fn(rank,
    world, device) -> dict`` that every rank runs inside the world.
    Returns one summary a job: rank 0's, with every rank's under
    ``"ranks"``.  Raises ``RuntimeError`` when a rank fails (its
    traceback in the message) or the world outlives ``timeout_s``; the
    other ranks are killed, and every collective times out on its own
    besides, so no rank hangs the launch."""
    import torch
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    from repro_torch import device as D
    jobs = [parse_args(list(j)) if isinstance(j, (list, tuple)) else j
            for j in jobs]
    for j in jobs:
        if isinstance(j, argparse.Namespace) and (
                j.devices != world or j.device != device
                or not _spawned(j)):
            raise ValueError(f"a job of this world must be a distributed "
                             f"run with --devices {world} --device "
                             f"{device}")
    dev = torch.device(device)
    if dev.type == "cuda":
        D.resolve(dev)                   # raises when CUDA is missing
        # built once here, before the ranks load it
        from repro_torch.kernels import build
        build.build()
        where = ", ".join(sorted({f"cuda:{r % torch.cuda.device_count()}"
                                  for r in range(world)}))
        staging = "CUDA tensors staged through pinned host buffers"
    else:
        where, staging = "cpu", "host tensors, no staging"
    print(f"distributed: backend gloo, world {world} (spawned "
          f"processes, file store), ranks on {where}; {staging}",
          flush=True)
    tmp = tempfile.mkdtemp(prefix="train_gnn_world_")
    try:
        ctx = mp.start_processes(_rank_main, args=(world, tmp, jobs, device,
                                                   timeout_s),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    for proc in ctx.processes:
                        proc.kill()
                    for proc in ctx.processes:
                        proc.join()
                    raise RuntimeError(f"train_gnn: the {world} ranks did "
                                       f"not finish in {timeout_s:.0f} s; "
                                       f"killed")
        except ProcessException as exc:
            raise RuntimeError(f"train_gnn: a rank failed: {exc}") from None
        per_rank = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                per_rank.append(pickle.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return [dict(per_rank[0][i], ranks=[per_rank[r][i]
                                        for r in range(world)])
            for i in range(len(jobs))]


def _rank_main(rank: int, world: int, tmp: str, jobs, device: str,
               timeout_s: float) -> None:
    """One rank: join the world, run the jobs, leave the summaries in
    ``tmp`` for the launcher."""
    import torch

    from repro_torch import device as D
    from repro_torch.core import collectives as C
    dev = D.resolve(C.rank_device(rank, device))
    if dev.type == "cpu":
        # the ranks share the machine's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    C.init_world(rank, world, dev, os.path.join(tmp, "store"),
                 timeout_s=min(timeout_s, C.DEFAULT_TIMEOUT_S))
    out = []
    try:
        for job in jobs:
            if not isinstance(job, argparse.Namespace):
                out.append(job(rank, world, dev))
                continue

            def fn(a):
                return _distributed_job(a, rank, world, dev)

            out.append(_with_telemetry(job, fn) if rank == 0 else fn(job))
    finally:
        C.shutdown()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".part", path)


def _quiet(*_a, **_k) -> None:
    pass


# each rank's graphs by what makes them: a world that runs several jobs
# on one graph makes it once (a job gets a shallow copy: folding an
# update stream replaces the copy's arrays, not the cached graph's)
_GRAPHS: dict = {}


def _rank_graph(args, log):
    import dataclasses
    key = (args.dataset, args.nodes, args.classes, args.feat_dim,
           args.seed, args.reorder)
    if key not in _GRAPHS:
        _GRAPHS[key] = reorder_for_launch(load_graph(args), args.reorder,
                                          log)
    g, info = _GRAPHS[key]
    return dataclasses.replace(g), info


def resolve_edge_cut(g, n_dev: int, method: str, log=print) -> str:
    """EASE-style auto selection, constrained to the edge-cut family the
    distributed full-graph paths require."""
    if method == "auto":
        from repro_torch.core.partitioning import select_partitioner
        method = select_partitioner(g, n_dev)
        if method == "hdrf":
            method = "ldg"
        log(f"auto-selected partitioner: {method}")
    return method


def _distributed_job(args, rank: int, world: int, dev, *,
                     steps_per_epoch: int = 0) -> dict:
    """One rank's part of one distributed run: the synchronous full-graph
    modes or ``--fullgraph`` (GCN), or ``--minibatch`` (any architecture
    the block forward takes; ``steps_per_epoch`` cuts its epoch short, as
    :func:`run`'s does).  Returns the rank's summary: losses, per-epoch
    (per-step) times and bytes, the launches of the port's kernels, the
    collectives' totals, the final parameters (numpy) and the path's own
    reports."""
    import torch

    from repro_torch.core import collectives as C
    from repro_torch.kernels import ops
    from repro_torch.models.gnn import model as GM
    from repro_torch.models.gnn.model import GNNConfig
    from repro_torch.optim import AdamW
    log = print if rank == 0 else _quiet
    g, reorder = _rank_graph(args, log)
    log(f"graph: {g.num_nodes} nodes, {g.num_edges} edges, "
        f"{g.num_classes} classes; {world} ranks, rank 0 on {dev}")
    cfg = GNNConfig(arch=args.arch if args.minibatch else "gcn",
                    feat_dim=g.features.shape[1], hidden=args.hidden,
                    num_classes=g.num_classes, wire_codec=args.wire_codec)
    # every rank draws the same initial parameters from the same seed
    model = GM.init_gnn(cfg, torch.Generator().manual_seed(args.seed),
                        device=dev)
    opt = AdamW(model.parameters(), lr=args.lr, weight_decay=0.0)
    method = resolve_edge_cut(g, world, args.partitioner, log)
    C.release_buffers()
    C.STATS.reset()
    ops.reset_launch_counts()
    if args.minibatch:
        out = _minibatch_dist(args, g, cfg, model, opt, method, rank, world,
                              dev, log, steps_per_epoch)
    else:
        path = _async_fullgraph if args.fullgraph else _sync_fullgraph
        out = path(args, g, reorder, cfg, model, opt, method, rank, world,
                   dev, log)
    out.update(
        rank=rank, world=world, device=str(dev), partitioner=method,
        reorder=reorder["policy"],
        launches={k: v for k, v in ops.launch_counts().items() if v},
        launches_by_width=ops.launch_counts_by_width(),
        comm=C.STATS.snapshot(),
        params=[{k: v.detach().cpu().numpy()
                 for k, v in layer.named_parameters()} for layer in model])
    return out


def _minibatch_dist(args, g, cfg, model, opt, method, rank, world, dev, log,
                    steps_per_epoch: int = 0) -> dict:
    """``--devices N --minibatch`` (reference ``launch/train_gnn.py:
    351-399``): the rank builds its own partition's store, draws the
    global seed batches every rank draws (``--seed``) in a
    ``HostPrefetcher`` thread, samples the seeds it owns, and takes one
    step a batch (``make_distributed_minibatch_step``).  The traffic of
    the trained batches (each batch carries the store's counters as they
    stood after it was sampled, so batches sampled ahead do not count) is
    summed over the ranks at each epoch's end: the reference's one-process
    ``stats()`` over the same batches."""
    import numpy as np
    import torch

    from repro_torch.core import collectives as C
    from repro_torch.core import telemetry
    from repro_torch.distributed import (DistributedMinibatchSampler,
                                         HostPrefetcher,
                                         make_distributed_minibatch_step)
    from repro_torch.distributed.sampler import COUNTERS
    t0 = time.perf_counter()
    ds = DistributedMinibatchSampler(
        g, world, [5, 5], args.batch, partitioner=method,
        cache_policy=args.cache, cache_capacity=g.num_nodes // 10,
        wire_codec=args.wire_codec, seed=args.seed, parts=(rank,))
    setup_s = time.perf_counter() - t0
    step = make_distributed_minibatch_step(cfg, opt)
    rng = np.random.default_rng(args.seed)

    def make_batch():
        seeds = rng.choice(g.num_nodes, args.batch, replace=False)
        batch = ds.sample_partition(rank, ds.owned_seeds(rank, seeds))
        return batch, len(seeds), ds.counters()

    def summed(counters) -> dict:
        tot = C.all_reduce_sum(torch.tensor([counters[k] for k in COUNTERS],
                                            dtype=torch.float64))
        return dict(zip(COUNTERS, (int(v) for v in tot.tolist())))

    steps_per_epoch = steps_per_epoch or max(1, g.num_nodes // args.batch)
    clock = C.StepClock(dev)
    m_step = telemetry.histogram(
        "train_step_seconds", "wall time per executed training step",
        mode="minibatch_dist")
    losses = []
    counters = traffic = dict.fromkeys(COUNTERS, 0)
    prefetch = HostPrefetcher(make_batch)
    try:
        for epoch in range(args.epochs):
            for _ in range(steps_per_epoch):
                batch, count, counters = next(prefetch)
                with clock.step(), telemetry.span("train.step",
                                                  mode="minibatch_dist"):
                    losses.append(float(step(model, batch, ds.out_deg,
                                             count)))
                m_step.observe(clock.rows[-1]["wall_s"])
            traffic = summed(counters)
            log(f"epoch {epoch:3d} loss {losses[-1]:.4f} halo_hit "
                f"{ds.stats(traffic)['halo_hit_ratio']:.2%}")
    finally:
        prefetch.close()
    st = ds.stats(traffic)
    trained = args.epochs * steps_per_epoch
    log(f"cross-partition traffic "
        f"{st['cross_partition_bytes'] / 2**20:.1f} MiB (wire codec "
        f"{st['wire_codec']}) over {trained} trained batches ({world} "
        f"ranks; rank 0 sampled {prefetch.produced}); halo_hit "
        f"{st['halo_hit_ratio']:.2%}; ghost fraction "
        f"{st['ghost_fraction']:.2f}; prefetch overlap "
        f"{prefetch.overlap_ratio():.0%}")
    return {"mode": "minibatch_dist", "losses": losses, "steps": clock.rows,
            "setup_s": setup_s, "trained": trained,
            "sampled": prefetch.produced, "counters": counters,
            "counters_sampled": ds.counters(), "traffic": traffic,
            "stats": st, "prefetch_overlap": prefetch.overlap_ratio(),
            "prefetch_wait_s": prefetch.wait_s,
            "sample_s": prefetch.sample_s}


def _sync_fullgraph(args, g, reorder, cfg, model, opt, method, rank, world,
                    dev, log) -> dict:
    """``--mode pull|push|stale|hysync``: one synchronous step a rank an
    epoch (``propagation.run_sync``)."""
    from repro_torch.core import propagation as PR
    t0 = time.perf_counter()
    sg = PR.shard_graph(g, world, method=method)
    cut_s = time.perf_counter() - t0
    out = PR.run_sync(model, opt, sg, g, rank, dev, mode=args.mode,
                      steps=args.epochs, staleness=args.staleness, log=log)
    out["setup_s"] += cut_s
    return out


def _async_fullgraph(args, g, reorder, cfg, model, opt, method, rank, world,
                     dev, log) -> dict:
    """``--fullgraph``: the staleness-bounded asynchronous trainer, with
    an update stream folded between epochs under ``--update-stream``
    (reference ``launch/train_gnn.py:234-282``)."""
    from repro_torch.distributed import AsyncFullGraphTrainer
    t0 = time.perf_counter()
    trainer = AsyncFullGraphTrainer(
        g, cfg, opt, world, partitioner=method,
        staleness=max(args.staleness, 0), refresh_frac=args.refresh_frac,
        device=dev)
    _sync(dev)
    setup_s = time.perf_counter() - t0
    folds = []
    if args.update_stream:
        from repro_torch.core.updates import load_update_stream
        ulog = load_update_stream(args.update_stream)
        if reorder["policy"] != "none":
            # the stream speaks original ids; the trainer's graph is
            # packed — relabel once at the boundary
            ulog = ulog.relabel(reorder["inv"])
        per = args.updates_per_epoch or math.ceil(
            ulog.last_seq / max(args.epochs - 1, 1))
        log(f"update stream: {ulog.last_seq} events from "
            f"{args.update_stream}, folding {per}/epoch")
        for epoch in range(args.epochs):
            loss = trainer.run(model, 1)
            if trainer._update_seq < ulog.last_seq:
                upto = min(trainer._update_seq + per, ulog.last_seq)
                t1 = time.perf_counter()
                fold = trainer.fold_updates(ulog, upto)
                fold["seconds"] = time.perf_counter() - t1
                folds.append(fold)
                log(f"epoch {epoch:3d} loss {loss:.4f} folded "
                    f"{fold['events']} events (touched "
                    f"{fold['touched_nodes']} nodes, invalidated "
                    f"{fold['invalidated_rows']} ghost rows)")
    else:
        trainer.run(model, args.epochs, log_every=5 if rank == 0 else 0)
    st = trainer.stats()
    acc = trainer.accuracy(model) if rank == 0 else None
    if rank == 0:
        log(f"final accuracy {acc:.3f}")
    log(f"ghost rows {st['ghost_rows']}; wire codec {st['wire_codec']}; "
        f"cross-partition {st['bytes_per_step'] / 1024:.1f} KiB/step vs "
        f"{st['sync_bytes_per_step'] / 1024:.1f} KiB/step synchronous "
        f"({st['comm_savings']:.0%} saved); "
        f"{st['mean_step_s'] * 1e3:.1f} ms/step")
    return {"mode": "fullgraph", "losses": trainer.losses,
            "epochs": trainer.clock.rows, "setup_s": setup_s,
            "stats": st, "accuracy": acc, "folds": folds,
            "update_seq": trainer._update_seq,
            "ghost_digest": trainer.ghost_digest(),
            "plan_digest": trainer.plan_digest().hex(),
            "n_local": trainer.sg.n_local, "n_pad": trainer.sg.n_pad,
            "edges": int(trainer.shard.graph.order.numel())}


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
