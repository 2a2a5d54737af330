"""Online GNN inference serving driver (PyTorch port).

Serves per-node prediction requests against a synthetic (or named) graph
through the ``repro_torch.serving`` stack: Poisson workload → bucketed
micro-batching → fixed-shape neighbor sampling → historical-embedding +
feature caching → forward on the device (the hand-written Hopper
aggregation kernels on a CUDA device).  Runs the same workload twice
(no-cache baseline, then the layered cache) and reports the traffic
saved.

  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --nodes 512 \\
      --requests 256 --arch sage --device cuda

GraphSAGE at Reddit's widths:

  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --arch sage \\
      --nodes 232965 --classes 41 --feat-dim 602 --hidden 256 \\
      --fanouts 10 25 --requests 256 --device cuda

A named graph of the synthetic registry (``--dataset``), a locality
order of the served graph (``--reorder``: requests and responses keep
their original ids) and a changing graph (``--update-stream``, a JSONL
log written by ``GraphUpdateLog.to_jsonl``, folded every
``--update-every`` completions):

  PYTHONPATH=src python -m repro_torch.launch.serve_gnn \\
      --dataset reddit-like --reorder bfs --update-stream u.jsonl

Replicated mode (``--replicas N`` or ``--autoscale``) serves through the
elastic :class:`repro_torch.serving.router.ReplicaRouter` instead: the
traffic spread over N replicas sharing one forward and (by default) one
embedding cache, optional queue-depth/p99 autoscaling, rolling weight
hot-swap every K completions with per-response version tags, and
crash-safe stop/resume through ``--ckpt-dir``.  The replicas run one
after another on one device and the router lays their measured compute
side by side in virtual time, so its req/s and p99 model N devices:

  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --replicas 2 \
      --hot-swap-every 100 --requests 256 --ckpt-dir ckpt
  PYTHONPATH=src python -m repro_torch.launch.serve_gnn --replicas 1 \
      --autoscale --rate 8000 --requests 512 --router-policy least_queue
"""
from __future__ import annotations

import argparse
import copy
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=512)
    ap.add_argument("--classes", type=int, default=4)
    ap.add_argument("--feat-dim", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--arch", default="sage",
                    choices=["gcn", "sage", "gat", "gin", "ggnn"])
    ap.add_argument("--dataset", default="",
                    help="named dataset from repro_torch.graph.datasets; "
                         "default: an SBM sized by --nodes")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--rate", type=float, default=2000.0,
                    help="offered load, requests/s (virtual clock)")
    ap.add_argument("--fanouts", type=int, nargs="+", default=[5, 5],
                    help="per-layer fanouts, innermost first")
    ap.add_argument("--buckets", type=int, nargs="+", default=[1, 4, 16, 64])
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--cache", default="degree",
                    choices=["none", "degree", "importance", "random"])
    ap.add_argument("--cache-frac", type=float, default=0.2,
                    help="fraction of nodes admitted to the caches")
    ap.add_argument("--staleness", type=int, default=0,
                    help="max staleness (version-clock ticks) served")
    ap.add_argument("--wire-codec", default="fp32",
                    choices=["fp32", "bf16", "int8"],
                    help="communication-plane wire codec "
                         "(repro_torch.core.comm) for remote feature "
                         "pulls and cache-fill payloads; fp32 is "
                         "bit-exact")
    ap.add_argument("--use-kernel", action="store_true",
                    help="accepted for parity with the reference; the "
                         "device decides (cuda runs the Hopper kernels)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; "
                         "raises when CUDA is missing)")
    ap.add_argument("--reorder", default="none",
                    choices=["none", "degree", "bfs", "rcm"],
                    help="locality-reorder the served graph (survey "
                         "§3.2.4); the sampler and caches operate on "
                         "the packed graph while request node ids map "
                         "in through the inverse permutation and "
                         "responses are reported in original ids")
    ap.add_argument("--replicas", type=int, default=1,
                    help="initial replica count; > 1 (or --autoscale) "
                         "serves through the elastic ReplicaRouter")
    ap.add_argument("--router-policy", default="least_queue",
                    choices=["round_robin", "least_queue"],
                    help="request dispatch policy across replicas")
    ap.add_argument("--private-cache", action="store_true",
                    help="one EmbeddingCache per replica instead of the "
                         "default fleet-shared cache")
    ap.add_argument("--autoscale", action="store_true",
                    help="enable the queue-depth/p99 autoscaling "
                         "controller (scales replicas within "
                         "[--replicas, --max-replicas])")
    ap.add_argument("--max-replicas", type=int, default=8,
                    help="autoscaler upper bound on the fleet size")
    ap.add_argument("--hot-swap-every", type=int, default=0,
                    help="stage a rolling weight hot-swap every K "
                         "completions (0 = never); new weights are a "
                         "fresh init per version, every response is "
                         "tagged with the one version that served it")
    ap.add_argument("--update-stream", default="",
                    help="JSONL graph-update stream "
                         "(repro_torch.core.updates.GraphUpdateLog "
                         "format) folded into the served graph mid-run: "
                         "incremental delta-frontier cache invalidation "
                         "instead of a cold restart; with --replicas the "
                         "router invalidates every replica")
    ap.add_argument("--update-every", type=int, default=0,
                    help="completions between update folds (0 = auto: "
                         "~4 folds across the run)")
    ap.add_argument("--ckpt-dir", default="",
                    help="replicated mode only: write a crash-safe "
                         "(params, version) checkpoint here after the "
                         "run; if it already holds a complete step, "
                         "resume weights from it")
    ap.add_argument("--train-epochs", type=int, default=0,
                    help="full-graph AdamW pre-training epochs before "
                         "serving (lr 1e-2, no weight decay)")
    ap.add_argument("--metrics-out", default="",
                    help="enable telemetry and write the Prometheus "
                         "text-format exposition here on exit "
                         "(repro_torch.core.telemetry)")
    ap.add_argument("--trace-out", default="",
                    help="enable telemetry and write the JSONL span "
                         "trace here on exit")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.ckpt_dir and not (args.replicas > 1 or args.autoscale):
        raise SystemExit("serve_gnn: --ckpt-dir is read only with "
                         "--replicas > 1 or --autoscale")
    return args


def main(argv=None):
    """Parse args, serve the workload, and (when asked) dump the
    telemetry plane on exit — metrics as Prometheus text, spans as JSONL
    (see docs/observability.md)."""
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


def run(args):
    """The serving driver; ``main`` wraps it with the telemetry dump.
    Returns the cached run's summary with the baseline's under
    ``"no_cache"`` (or the baseline's alone under ``--cache none``); in
    replicated mode, the router's summary."""
    import numpy as np
    import torch

    from repro_torch import device as D
    from repro_torch.launch.train_gnn import load_graph, reorder_for_launch
    from repro_torch.models.gnn import model as GM
    from repro_torch.models.gnn.model import GNNConfig
    from repro_torch.serving import GNNInferenceServer, poisson_workload

    device = D.resolve(args.device)
    g = load_graph(args)
    print(f"graph: {g.num_nodes} nodes, {g.num_edges} edges, "
          f"{g.num_classes} classes")
    # the serving stack (sampler, feature and embedding caches) operates
    # entirely on the packed graph; external node ids cross the API
    # boundary through inv (in) and perm (out)
    g, reorder = reorder_for_launch(g, args.reorder)
    perm = inv = None
    if args.reorder != "none":
        perm, inv = reorder["perm"], reorder["inv"]

    cfg = GNNConfig(arch=args.arch, feat_dim=g.features.shape[1],
                    hidden=args.hidden, num_classes=g.num_classes,
                    num_layers=len(args.fanouts),
                    use_kernel=args.use_kernel,
                    wire_codec=args.wire_codec)
    params = GM.init_gnn(cfg, torch.Generator().manual_seed(args.seed),
                         device=device)

    if args.train_epochs:
        from repro_torch.core.abstraction import DeviceGraph
        from repro_torch.optim import AdamW
        opt = AdamW(params.parameters(), lr=1e-2, weight_decay=0.0)
        dg = DeviceGraph.from_graph(g, device, src_layout=True)
        x = torch.from_numpy(g.features).to(device)
        y = torch.from_numpy(g.labels).to(device)
        mask = torch.ones(y.shape, dtype=torch.float32, device=device)
        step = GM.make_fullgraph_train_step(cfg, opt)
        for _ in range(args.train_epochs):
            loss = step(params, dg, x, y, mask)
        print(f"pre-trained {args.train_epochs} epochs, "
              f"loss {float(loss):.4f}")
    print(f"model: {cfg.arch} {cfg.feat_dim}->{cfg.hidden}->"
          f"{cfg.num_classes}, fanouts {args.fanouts}, on {device}")

    # the workload arrives in ORIGINAL node ids (clients know nothing of
    # the packing); ids map into the packed space here, at the boundary
    workload = poisson_workload(args.requests, np.arange(g.num_nodes),
                                args.rate, seed=args.seed + 1)
    if inv is not None:
        for r in workload:
            r.node_id = int(inv[r.node_id])
    capacity = int(g.num_nodes * args.cache_frac)

    if args.replicas > 1 or args.autoscale:
        out = _run_replicated(args, g, cfg, params, workload, capacity,
                              _update_stream_kw(args, inv), device)
        if perm is not None:
            for r in workload:
                r.node_id = int(perm[r.node_id])
        return out

    def serve(policy: str) -> dict:
        srv = GNNInferenceServer(
            g, cfg, params, fanouts=args.fanouts, buckets=args.buckets,
            cache_policy=policy, cache_capacity=capacity,
            max_staleness=args.staleness,
            max_wait_s=args.max_wait_ms / 1e3, seed=args.seed)
        srv.warmup()
        # each serve pass folds a fresh copy of the stream into a fresh
        # copy of the graph, so baseline and cached runs stay comparable
        kw = _update_stream_kw(args, inv)
        if kw:
            srv.g = srv.sampler.g = copy.deepcopy(g)
            srv.cache.g = srv.cache.features.g = srv.g
            srv.sampler.apply_delta(np.zeros(0, np.int64))
        wl = copy.deepcopy(workload)
        srv.run(wl, **kw)
        if perm is not None:
            # report completed responses in the clients' original ids
            for r in wl:
                r.node_id = int(perm[r.node_id])
        out = srv.summary()
        out["update_seq"] = srv._update_seq
        out["reorder"] = reorder
        out["folds"] = srv.folds
        out["forward_calls"] = srv.forward_calls
        out["all_logits_finite"] = all(
            r.logits is not None and bool(np.isfinite(r.logits).all())
            for r in wl)
        # the answered requests and the server that answered them, for a
        # caller that checks them (the summary's numbers stay JSON-able)
        out["responses"], out["server"] = wl, srv
        return out

    base = serve("none")
    print(f"[no-cache ] {base['throughput_rps']:8.1f} req/s  "
          f"p50 {base['p50_ms']:6.2f} ms  p99 {base['p99_ms']:6.2f} ms  "
          f"feature bytes {base['feature_bytes'] / 2**20:.2f} MiB")

    if args.cache == "none":
        print("done (cache disabled)")
        return base

    res = serve(args.cache)
    saved = base["feature_bytes"] - res["feature_bytes"]
    print(f"[{args.cache:9s}] {res['throughput_rps']:8.1f} req/s  "
          f"p50 {res['p50_ms']:6.2f} ms  p99 {res['p99_ms']:6.2f} ms  "
          f"feature bytes {res['feature_bytes'] / 2**20:.2f} MiB")
    print(f"embedding hit rate {res['embedding_hit_ratio']:.2%}  "
          f"feature hit rate {res['feature_hit_ratio']:.2%}  "
          f"pad overhead {res['pad_overhead']:.2%}  "
          f"jit entries {res['jit_entries']}")
    print(f"wire codec {res['wire_codec']}: feature "
          f"{res['feature_bytes'] / 2**20:.2f} MiB + cache-fill "
          f"{res['fill_bytes'] / 2**20:.2f} MiB = "
          f"{res['wire_bytes'] / 2**20:.2f} MiB on the wire")
    print(f"bytes saved vs no-cache: {saved / 2**20:.2f} MiB "
          f"({saved / max(base['feature_bytes'], 1):.1%})")
    if res["folds"]:
        folds = res["folds"]
        print(f"graph updates folded through seq {res['update_seq']} in "
              f"{len(folds)} folds: touched "
              f"{sum(f['touched_nodes'] for f in folds)} nodes, "
              f"invalidated {sum(f['invalidated_rows'] for f in folds)} "
              f"cache rows")
    res["no_cache"] = base
    return res


def _update_stream_kw(args, inv=None) -> dict:
    """Build the ``run(update_log=, update_every=, update_chunk=)``
    kwargs for ``--update-stream``: default cadence folds after every
    quarter of the workload, spreading the stream across ~4 chunks so
    mutations actually interleave with traffic (an end-of-run fold would
    never exercise mid-run invalidation).  ``inv`` relabels an
    original-id stream into the packed id space under ``--reorder``."""
    if not args.update_stream:
        return {}
    from repro_torch.core.updates import load_update_stream
    log = load_update_stream(args.update_stream)
    if inv is not None:
        log = log.relabel(inv)
    every = args.update_every or max(1, args.requests // 4)
    chunk = max(1, -(-log.last_seq // 4))          # ceil(last_seq / 4)
    print(f"update stream: {log.last_seq} events from "
          f"{args.update_stream}, folding {chunk} events every "
          f"{every} completions")
    return {"update_log": log, "update_every": every,
            "update_chunk": chunk}


def _run_replicated(args, g, cfg, params, workload, capacity, update_kw,
                    device):
    """Serve through the elastic ReplicaRouter: N replicas, optional
    autoscaling, rolling hot-swap every K completions, crash-safe
    stop/resume via ``--ckpt-dir``."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import latest_step
    from repro_torch.models.gnn import model as GM
    from repro_torch.serving import (AutoscalePolicy, ReplicaRouter,
                                     restore_params)

    router = ReplicaRouter(
        g, cfg, params,
        n_replicas=args.replicas,
        policy=args.router_policy,
        shared_cache=not args.private_cache,
        cache_policy=args.cache,
        cache_capacity=capacity,
        max_staleness=args.staleness,
        fanouts=args.fanouts,
        buckets=args.buckets,
        max_wait_s=args.max_wait_ms / 1e3,
        seed=args.seed,
        autoscale=AutoscalePolicy(
            min_replicas=args.replicas,
            max_replicas=args.max_replicas) if args.autoscale else None)

    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        resumed, version = restore_params(args.ckpt_dir, params)
        print(f"resumed weights from {args.ckpt_dir} "
              f"(params version {version})")
        if version > 0:
            router.hot_swap(resumed, version=version)
        else:
            router.params = resumed
            for rep in router.replicas:
                rep.server.params = resumed

    def fresh_params(version: int):
        return GM.init_gnn(cfg, torch.Generator().manual_seed(
            args.seed + version), device=device)

    stats = router.run(workload,
                       hot_swap_every=args.hot_swap_every,
                       new_params_fn=(fresh_params
                                      if args.hot_swap_every else None),
                       **update_kw)
    out = router.summary()
    if update_kw:
        print(f"graph updates folded through seq {router._update_seq}")
    mode = "autoscale" if args.autoscale else "fixed"
    # req/s divides by the host's wall time, in which the replicas ran
    # one after another on this device; p50/p99 are on the virtual
    # clock, where each replica models a device of its own
    print(f"[replicated] {args.router_policy}/{mode}  "
          f"{out['throughput_rps']:8.1f} req/s (wall, replicas in turn on "
          f"{device})  p50 {out['p50_ms']:6.2f} ms  p99 "
          f"{out['p99_ms']:6.2f} ms (virtual clock)")
    print(f"served {out['served']}  dropped {out['dropped']}  "
          f"torn batches {out['torn_batches']}  "
          f"hot swaps {out['hot_swaps']}  "
          f"replicas peak {stats.replicas_peak} "
          f"final {stats.replicas_final}  "
          f"scale events {out['scale_events']}")
    print(f"version counts {out['version_counts']}  "
          f"serving version {out['params_version']}")
    if "embedding_hit_ratio" in out:
        kind = "shared" if out["shared_cache"] else "private"
        print(f"{kind} cache hit rate {out['embedding_hit_ratio']:.2%}  "
              f"wire {out['wire_bytes'] / 2**20:.2f} MiB")
    if args.ckpt_dir:
        path = router.save(args.ckpt_dir)
        print(f"checkpoint -> {path}")
    out["update_seq"] = router._update_seq
    out["forward_calls"] = router.forward_calls
    out["all_logits_finite"] = all(
        r.logits is not None and bool(np.isfinite(r.logits).all())
        for r in workload)
    # the answered requests and the router that answered them, for a
    # caller that checks them (the summary's numbers stay JSON-able)
    out["responses"], out["router"] = workload, router
    return out


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
