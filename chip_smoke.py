#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and
check it.  Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure makes the exit code nonzero:

1. the card (``nvidia-smi`` name and power limit); build the Hopper
   kernels from ``src/repro_torch/kernels/csrc`` and time the build;
2. each forward kernel (K1 gather-scale-segment-sum, K2 segment-sum, K3
   GAT attention) at the full-width shapes of the GraphSAGE-Reddit
   serving path plus edge cases: max abs error against its plain PyTorch
   version (bound 1e-4 · max|plain|), bitwise repeatability, and the
   median over 25 timed launches (CUDA events around one launch queued
   behind a device sleep, L2 flushed before each) of the kernel, the
   plain version and, where one PyTorch call computes the same function,
   that call; beside the least time the card could take (bytes over
   3.35 TB/s, or flops over 67 TFLOP/s fp32);
3. serve GraphSAGE at Reddit's widths (602 → 256 → 41, fanouts 10/25,
   232 965 nodes) through ``repro_torch.launch.serve_gnn``: 128
   requests, throughput, p50/p99, the sample/forward span split; K1 must
   launch twice per forward; one bucket-64 batch of SAGE, GIN and GAT
   each on the card agrees with the CPU to 1e-4; ``torch.profiler``
   splits one SAGE forward's device time by kernel and copy;
4. serve GIN (602 → 256 → 41) and GAT (602 → 256 → 40: its output layer
   splits the classes over 4 heads, and 41 does not split) at Reddit's
   widths and fanouts, 64 requests each; each forward launches exactly
   its kernels (GIN: K2 twice and K5, its Scatter, twice; GAT: K3
   twice);
5. the training kernels at every shape the full-batch trainers feed
   them, checked and timed as in phase 2, over the whole graph: K1 (F
   602, 256, 41) and its transpose over the src-grouped layout (F 256,
   41, and 4 heads x 64 and x 10), K2 (602, 256, 4 wide; either layout),
   K5 (602 and 256 wide), K3 and K6 (4 x 64, 4 x 10; K6 also 1 x 256) on
   GAT's 40-class graph, K4 on the int8 rows of a batch-1024 block, the
   GAT backward at both layers; and each autograd Function's gradients
   (K1, K2, the Scatter gather, K3) against autograd through the plain
   versions;
6. full-batch training at Reddit's widths through
   ``repro_torch.launch.train_gnn``: GCN, SAGE, GIN (602 → 256 → 41) and
   GAT (→ 40), 10 epochs each: the loss is finite and falls, every step
   launches exactly the kernels of its design and nothing plain, a second
   run from the same init ends in bitwise-equal parameters, one step's
   gradients on the card agree with the same step on the CPU (in
   float64) to 1e-4 of the model's largest gradient; ms per epoch, peak
   device memory, a
   ``torch.profiler`` split of one GCN step by kernel, matrix product and
   copy (alone in a profiling session, and after a profiled warm-up
   step), and CUDA-event times of its two large products;
7. mini-batch GraphSAGE at Reddit's widths: ``--batch 1024 --epochs 1
   --cache degree`` with ``--wire-codec fp32`` and then ``int8
   --use-kernel`` (wire rows into K4); K4 launches once per int8 step
   and never under fp32; step time, cache
   hit ratio, fetched MiB and the loss trend.

The last lines are the card's ``nvidia-smi`` line, one
``{"kernels": [...]}`` JSON line, and
``{"ok": true, "device": {...}}``.  Exits nonzero, printing no result,
when CUDA is not available.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12           # float32 outside the tensor cores
REPS = 25
# GraphSAGE at Reddit's published widths (Hamilton et al. 2017 regime,
# hidden 256 as in PyG's examples/reddit.py); fanouts innermost first
NODES, CLASSES, FEAT, HIDDEN, FANOUTS = 232965, 41, 602, 256, (10, 25)
BUCKET = 64
# GAT reshapes its output layer's classes into 4 heads: 40 is the class
# count nearest Reddit's 41 that splits (4 x 10)
GAT_HEADS, GAT_CLASSES = 4, 40
# each served path: (arch, classes, its kernel launches per forward)
SERVED = (("sage", CLASSES, {"gather_scale_segment_sum": 2}),
          ("gin", CLASSES, {"segment_sum": 2, "gather_rows": 2}),
          ("gat", GAT_CLASSES, {"gat_attention": 2}))
TRAIN_EPOCHS = 10
# the kernel launches of one full-batch training step (2 layers), by
# design: a backward runs only what needs_input_grad asks for (layer 0's
# input features carry no gradient, so SAGE and GIN skip that transpose)
STEP_LAUNCHES = {
    "gcn": {"gather_scale_segment_sum": 2, "gather_scale_segment_sum_t": 2},
    "sage": {"gather_scale_segment_sum": 2, "gather_scale_segment_sum_t": 1},
    "gin": {"gather_rows": 3, "segment_sum": 3},
    "gat": {"gat_attention": 2, "gather_scale_segment_sum_t": 2,
            "edge_dot": 2,
            "segment_sum": 6},
}
# the launches of the forward that measures the final accuracy
EVAL_LAUNCHES = {"gcn": {"gather_scale_segment_sum": 2},
                 "sage": {"gather_scale_segment_sum": 2},
                 "gin": {"gather_rows": 2, "segment_sum": 2},
                 "gat": {"gat_attention": 2}}
MB_BATCH = 1024

failures: list = []


def phase(name):
    """Run one phase; record (not swallow) its failure so later phases
    still report, and the run still exits nonzero."""
    def wrap(fn):
        def run(*a, **kw):
            print(f"== {name}", flush=True)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            except Exception:
                failures.append(name)
                traceback.print_exc()
                print(f"FAILED: {name}", flush=True)
                return None
            finally:
                print(f"   ({time.perf_counter() - t0:.1f} s)", flush=True)
        return run
    return wrap


def require(ok: bool, what: str) -> None:
    """A check of the run (not an ``assert``: it holds under -O too)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing and checking helpers
# ---------------------------------------------------------------------------

def median_ms(torch, fn, flush) -> float:
    """Median device time of one call, L2 cold.  A ~1 ms device sleep
    queued before the start event keeps the card busy while the host
    enqueues the call, so host launch overhead stays out of the reading
    (a call that synchronises inside still shows its idle gaps)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(bytes_: float, flops: float) -> tuple:
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_case(torch, label, kernel, plain, args, *, timed=False,
               library=None, bytes_=0.0, flops=0.0, flush=None):
    """Kernel vs plain on the same inputs; optionally timed.  Returns the
    measurement dict and records a failure on disagreement."""
    out1 = kernel(*args)
    out2 = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    err = (out1 - ref).abs().max().item() if ref.numel() else 0.0
    scale = ref.abs().max().item() if ref.numel() else 0.0
    bitwise = torch.equal(out1, out2)
    finite = bool(torch.isfinite(out1).all())
    ok = finite and bitwise and err <= 1e-4 * scale
    res = {"case": label, "shape": list(out1.shape), "max_abs_err": err,
           "max_abs_ref": scale, "bitwise_repeatable": bitwise, "ok": ok}
    if timed:
        res["ms"] = median_ms(torch, lambda: kernel(*args), flush)
        res["plain_ms"] = median_ms(torch, lambda: plain(*args), flush)
        res["library_ms"] = (median_ms(torch, library, flush)
                             if library is not None else None)
        res["bound_ms"], res["bound_by"] = bound(bytes_, flops)
    print("   " + json.dumps(res), flush=True)
    if not ok:
        failures.append(f"{label}: err {err} (max|ref| {scale}), "
                        f"bitwise {bitwise}, finite {finite}")
    return res


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

@phase("1. card and kernel build")
def phase_build(torch):
    from repro_torch.kernels import build
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    out_dir, seconds, logs = build.build()
    print(f"   kernels built in {seconds:.1f} s -> {out_dir}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"   ptxas {name}: {line.strip()}")


def reddit_graph(classes=CLASSES):
    """The graph ``train_gnn``/``serve_gnn`` make at Reddit's widths."""
    from repro_torch.graph import generators as G
    g = G.sbm(NODES, classes, p_in=0.9, p_out=0.02, seed=0)
    return G.featurize(g, FEAT, seed=0, class_sep=1.5)


def sampled_blocks(g, fanouts, seed=0):
    """One bucket-64 batch of the serving sampler: (inner, outer) blocks
    and the input features of the inner block's sources."""
    from repro_torch.serving.sampler import ServingSampler
    seeds = np.random.default_rng(seed).choice(g.num_nodes, BUCKET,
                                               replace=False)
    mb = ServingSampler(g, fanouts, seed=seed).sample(seeds)
    ids = mb.input_nodes
    x = np.where((ids >= 0)[:, None], g.features[np.maximum(ids, 0)], 0.0)
    return mb.blocks, x.astype(np.float32)


def _dev_graph(torch, block, dev, *, all_valid=False, seed=0):
    """DeviceGraph of a sampled block, or of the same shapes with every
    edge slot valid and random sources (Reddit's degree ~492 fills every
    fanout slot)."""
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.core.sampling import Block
    if all_valid:
        rng = np.random.default_rng(seed)
        E, D, S = len(block.edge_mask), block.num_dst, block.num_src
        block = Block(block.src_nodes, block.dst_nodes,
                      rng.integers(0, S, E).astype(np.int32),
                      (np.arange(E) // (E // D)).astype(np.int32),
                      np.ones(E, bool))
    return DeviceGraph.from_block(block, dev)


def _tiny_graph(dev, num_src, num_dst, E, masked):
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.core.sampling import Block
    return DeviceGraph.from_block(Block(
        np.arange(num_src), np.arange(num_dst), np.zeros(E, np.int32),
        np.zeros(E, np.int32), np.zeros(E, bool) if masked
        else np.ones(E, bool)), dev)


def _distinct_src(g) -> int:
    """Source rows the listed (valid) edges read, each counted once."""
    return int(g.edge_src[g.order.long()].unique().numel())


class Checker:
    """Kernel-against-plain checks on the card (``check_case``), with the
    bytes and operations of each case's bound and its one-call library
    counterpart where PyTorch has one; inputs from one CPU generator."""

    def __init__(self, torch, seed):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.gen = torch.Generator(device="cpu").manual_seed(seed)
        self.flush = torch.empty(64 * 2**20 // 4, device=self.dev)  # > L2

    def randn(self, *shape):
        return self.torch.randn(shape, generator=self.gen).to(self.dev)

    def k1(self, label, h, idx, coef, order, row_ptr, num_out, *,
           transpose=False, timed=True):
        """K1 ``out[d] = sum coef_e h[idx_e]`` over a grouped layout; over
        the src layout (gathering through ``edge_dst``) it is the
        transpose.  ``coef`` (E,) or (E, heads)."""
        torch = self.torch
        from repro_torch.kernels import segment_sum as ss
        nnz, F = int(order.numel()), h.shape[1]
        heads = 1 if coef.dim() == 1 else coef.shape[1]
        cols = idx[order.long()].long()
        U = int(cols.unique().numel())
        library = None
        if heads == 1:
            A = torch.sparse_csr_tensor(row_ptr.long(), cols,
                                        coef[order.long()],
                                        size=(num_out, h.shape[0]))
            library = lambda: torch.sparse.mm(A, h)
        kernel = functools.partial(ss.gather_scale_segment_sum_cuda,
                                   transpose=transpose)
        return check_case(
            torch, label, kernel, ss.gather_scale_segment_sum_plain,
            (h, idx, coef, order, row_ptr, num_out), timed=timed,
            library=library,
            bytes_=4 * (U * F + num_out * F) + (8 + 4 * heads) * nnz,
            flops=2 * nnz * F, flush=self.flush)

    def k2(self, label, msgs, seg, order, row_ptr, num_out, *, timed=True):
        """K2 ``out[d] = sum msgs[e]`` over the layout grouped by ``seg``;
        the library call adds every edge's row (masked rows are zero)."""
        torch = self.torch
        from repro_torch.kernels import segment_sum as ss
        nnz, F = int(order.numel()), msgs.shape[1]
        idx = seg.long()
        return check_case(
            torch, label, ss.segment_sum_cuda, ss.segment_sum_plain,
            (msgs, order, row_ptr, num_out), timed=timed,
            library=lambda: torch.zeros((num_out, F), device=self.dev
                                        ).index_add_(0, idx, msgs),
            bytes_=4 * (nnz * F + num_out * F) + 8 * nnz, flops=nnz * F,
            flush=self.flush)

    def k3(self, label, g, heads, hd, *, timed=True):
        """K3 over ``g``'s dst layout with random projections."""
        from repro_torch.kernels import gat_fused
        S, D = g.num_src, g.num_dst
        hs, es, ed = (self.randn(S, heads * hd), self.randn(S, heads),
                      self.randn(D, heads))
        nnz, U = int(g.order.numel()), _distinct_src(g)
        return check_case(
            self.torch, label, gat_fused.gat_attention_cuda,
            gat_fused.gat_attention_plain,
            (hs, es, ed, g.edge_src, g.order, g.row_ptr, D), timed=timed,
            bytes_=(4 * (U * heads * hd + D * heads * hd + U * heads
                         + D * heads) + 12 * nnz),
            flops=nnz * heads * (8 + 2 * hd), flush=self.flush)

    def k5(self, label, rows, seg, order, num_edges, *, timed=True):
        """K5 ``out[e] = rows[seg_e]`` on the listed edges."""
        torch = self.torch
        from repro_torch.kernels import segment_sum as ss
        nnz, F = int(order.numel()), rows.shape[1]
        U = int(seg[order.long()].unique().numel())
        idx = seg.long()
        return check_case(
            torch, label, ss.gather_rows_cuda, ss.gather_rows_plain,
            (rows, seg, order, num_edges), timed=timed,
            library=lambda: torch.index_select(rows, 0, idx),
            bytes_=4 * (U * F + nnz * F) + 8 * nnz, flush=self.flush)


@phase("2. kernels vs plain versions")
def phase_kernels(torch, blocks, x_np, results):
    c = Checker(torch, seed=0)
    dev = c.dev
    inner, outer = blocks

    def k1(g, h, label, timed=False):
        return c.k1(label, h, g.edge_src, g.edge_mask.to(torch.float32),
                    g.order, g.row_ptr, g.num_dst, timed=timed)

    def k2(g, F, label, timed=False):
        msgs = c.randn(g.edge_src.numel(), F) * \
            g.edge_mask[:, None].to(torch.float32)
        return c.k2(label, msgs, g.edge_dst, g.order, g.row_ptr, g.num_dst,
                    timed=timed)

    def k5(g, rows, label, timed=False):
        return c.k5(label, rows, g.edge_src, g.order, g.edge_src.numel(),
                    timed=timed)

    g_in, g_out = _dev_graph(torch, inner, dev), _dev_graph(torch, outer, dev)
    g_full = _dev_graph(torch, inner, dev, all_valid=True)
    x = torch.from_numpy(x_np).to(dev)
    h1 = c.randn(g_out.num_src, HIDDEN)
    print(f"   inner block: {g_in.num_dst} dst, {g_in.num_src} src, "
          f"{g_in.edge_src.numel()} slots, {g_in.order.numel()} valid; "
          f"outer: {g_out.num_dst} dst, {g_out.num_src} src, "
          f"{g_out.edge_src.numel()} slots, {g_out.order.numel()} valid")
    results["gather_scale_segment_sum"] = k1(
        g_in, x, "K1 inner sampled (18304x602 -> 1664)", timed=True)
    results["gather_scale_segment_sum.outer"] = k1(
        g_out, h1, "K1 outer sampled (1664x256 -> 64)", timed=True)
    results["gather_scale_segment_sum.full"] = k1(
        g_full, x, "K1 inner, every slot valid", timed=True)
    results["segment_sum"] = k2(g_in, FEAT, "K2 GIN layer 0 sampled "
                                "(16640x602 -> 1664)", timed=True)
    results["segment_sum.full"] = k2(g_full, FEAT, "K2 every slot valid",
                                     timed=True)
    results["gat_attention"] = c.k3("K3 inner sampled (18304x4x64 -> 1664)",
                                    g_in, 4, HIDDEN // 4)
    results["gat_attention.full"] = c.k3("K3 every slot valid", g_full, 4,
                                         HIDDEN // 4)
    # GIN's Scatter (K5) on the served blocks: 602-wide rows take the
    # float2 path, 256-wide rows the float4 path
    results["gather_rows.serve"] = k5(
        g_in, x, "K5 GIN layer 0 sampled Scatter (16640 x 602)", timed=True)
    results["gather_rows.serve.outer"] = k5(
        g_out, h1, "K5 GIN layer 1 sampled Scatter (1600 x 256)", timed=True)
    # the other shapes the served paths feed the kernels: GIN's layer 1
    # (F 256: float4 loads), GAT's 40-class output layer (4 x 10), and
    # the launcher's default widths (F 32 and 64, 4 x 16, 4 x 1)
    k2(g_out, HIDDEN, "K2 GIN layer 1 sampled (1600x256 -> 64)")
    c.k3("K3 outer, 4 heads of width 10", g_out, GAT_HEADS,
         GAT_CLASSES // GAT_HEADS, timed=False)
    k2(g_in, 32, "K2 inner, F=32")
    k2(g_out, 64, "K2 outer, F=64")
    c.k3("K3 inner, 4 heads of width 16", g_in, 4, 16, timed=False)
    c.k3("K3 outer, 4 heads of width 1", g_out, 4, 1, timed=False)
    for E, masked, what in [(0, False, "E=0"), (40, True, "all masked")]:
        tg = _tiny_graph(dev, 30, 20, E, masked)
        k1(tg, c.randn(30, 37), f"K1 {what}")
        k2(tg, 5, f"K2 {what}")
        c.k3(f"K3 {what}", tg, 4, 3, timed=False)
        k5(tg, c.randn(30, 6), f"K5 {what}")
    # empty destinations: every pad dst slot of the sampled blocks
    empty = int((g_in.row_ptr[1:] == g_in.row_ptr[:-1]).sum())
    print(f"   empty destinations in the inner block: {empty}")


def span_totals(telemetry) -> dict:
    out = {}
    for name in ("serve.batch", "serve.sample", "serve.forward"):
        durs = [e["dur"] for e in telemetry.get_registry().tracer.events
                if e["name"] == name]
        out[name] = {"count": len(durs), "total_s": float(np.sum(durs)),
                     "median_ms": float(np.median(durs)) * 1e3
                     if durs else 0.0}
    return out


@phase("3. serve GraphSAGE at Reddit widths")
def phase_serve(torch, results):
    from repro_torch.core import telemetry
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_gnn
    telemetry.set_enabled(True)
    telemetry.get_registry().reset()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve_gnn.main([
        "--arch", "sage", "--nodes", str(NODES), "--classes", str(CLASSES),
        "--feat-dim", str(FEAT), "--hidden", str(HIDDEN), "--fanouts",
        *map(str, FANOUTS), "--requests", "128", "--device", "cuda"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    wall = time.perf_counter() - t0
    spans = span_totals(telemetry)
    telemetry.set_enabled(False)
    base = res["no_cache"]
    forwards = res["forward_calls"] + base["forward_calls"]
    summary = {k: res[k] for k in ("served", "batches", "throughput_rps",
                                   "p50_ms", "p99_ms", "jit_entries",
                                   "embedding_hit_ratio",
                                   "feature_bytes", "wire_bytes")}
    summary["no_cache"] = {k: base[k] for k in (
        "served", "batches", "throughput_rps", "p50_ms", "p99_ms")}
    summary.update(forward_calls=forwards, launches=counts, spans=spans,
                   wall_s=wall)
    print("   serve: " + json.dumps(summary), flush=True)
    results["serve"] = summary
    results["launches.sage"] = counts
    require(res["served"] == 128 and base["served"] == 128,
            "every request served")
    require(res["all_logits_finite"] and base["all_logits_finite"],
            "finite logits")
    require(counts["gather_scale_segment_sum"] == 2 * forwards,
            f"K1 launched twice per forward: {counts}, {forwards} forwards")


@phase("3b. one full-width batch of each served arch on the card vs the CPU")
def phase_cpu_parity(torch, blocks, x_np):
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.models.gnn import model as GM
    rng = np.random.default_rng(1)
    inner, outer = blocks
    cached = rng.standard_normal((outer.num_src, HIDDEN)).astype(np.float32)
    fresh = rng.random(outer.num_src) < 0.3
    for arch, classes, _ in SERVED:
        cfg = GM.GNNConfig(arch=arch, feat_dim=FEAT, hidden=HIDDEN,
                           num_classes=classes, num_layers=2)
        outs = {}
        for dev in ("cuda", "cpu"):
            model = GM.init_gnn(cfg, torch.Generator().manual_seed(5),
                                device=dev)
            with torch.inference_mode():
                logits, h = GM.forward_blocks_cached(
                    cfg, model, [DeviceGraph.from_block(inner, dev)],
                    DeviceGraph.from_block(outer, dev),
                    torch.from_numpy(x_np).to(dev),
                    torch.from_numpy(cached).to(dev),
                    torch.from_numpy(fresh).to(dev))
            outs[dev] = (logits.cpu().numpy(), h.cpu().numpy())
        for i, what in enumerate(("logits", "hidden")):
            a, b = outs["cuda"][i], outs["cpu"][i]
            err = float(np.abs(a - b).max())
            scale = float(np.abs(b).max())
            print(f"   {arch} {what} {a.shape}: max abs err cuda vs cpu "
                  f"{err:.3e} (max|cpu| {scale:.3e})")
            require(bool(np.isfinite(a).all())
                    and err <= 1e-4 * max(scale, 1.0),
                    f"{arch} {what}: cuda agrees with cpu")


@phase("3c. where one serving forward spends device time")
def phase_profile(torch, blocks, x_np):
    """One bucket-64 forward as ``serve_batch`` runs it (host arrays to
    the card, forward, logits back): its wall time, the host-to-card copy
    of the input rows alone, and under ``torch.profiler`` the device time
    by kernel and the kernels' share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.models.gnn import model as GM
    cfg = GM.GNNConfig(arch="sage", feat_dim=FEAT, hidden=HIDDEN,
                       num_classes=CLASSES, num_layers=2)
    model = GM.init_gnn(cfg, torch.Generator().manual_seed(5), device="cuda")
    inner, outer = blocks
    cached = np.zeros((outer.num_src, HIDDEN), np.float32)
    fresh = np.zeros(outer.num_src, bool)

    def step():
        dev = torch.device("cuda")
        with torch.inference_mode():
            logits, _ = GM.forward_blocks_cached(
                cfg, model, [DeviceGraph.from_block(inner, dev)],
                DeviceGraph.from_block(outer, dev),
                torch.from_numpy(x_np).to(dev),
                torch.from_numpy(cached).to(dev),
                torch.from_numpy(fresh).to(dev))
            return logits.cpu()

    def median_wall_ms(fn):
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls))

    wall_ms = median_wall_ms(step)
    copy_ms = median_wall_ms(lambda: torch.from_numpy(x_np).to("cuda"))
    for _ in range(2):             # the first session pays CUPTI's start-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    # device-side kernels only: CPU ops carry their children's device time
    # too, and the profiler stretches pageable copies (timed by the host
    # clock above instead)
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type != DeviceType.CPU
                   and not e.key.startswith(("Memcpy", "Memset"))),
                  key=dev_us, reverse=True)
    kernels_ms = sum(dev_us(e) for e in rows) / 1e3
    print(f"   step wall {wall_ms:.3f} ms (median of 5); input rows "
          f"{x_np.nbytes / 2**20:.1f} MiB host -> card {copy_ms:.3f} ms "
          f"({x_np.nbytes / copy_ms / 1e6:.1f} GB/s); kernels "
          f"{kernels_ms:.3f} ms of device time ({kernels_ms / wall_ms:.2%} "
          f"of the step)")
    for e in rows[:8]:
        print(f"   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<3d} {e.key[:90]}")


@phase("4. serve GIN and GAT at Reddit widths")
def phase_gin_gat(torch, results):
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_gnn
    for arch, classes, per_forward in SERVED[1:]:
        ops.reset_launch_counts()
        res = serve_gnn.main([
            "--arch", arch, "--nodes", str(NODES), "--classes", str(classes),
            "--feat-dim", str(FEAT), "--hidden", str(HIDDEN), "--fanouts",
            *map(str, FANOUTS), "--requests", "64", "--device", "cuda"])
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        base = res["no_cache"]
        forwards = res["forward_calls"] + base["forward_calls"]
        summary = {"served": res["served"], "forward_calls": forwards,
                   "launches": counts, "no_cache": {
                       k: base[k] for k in ("throughput_rps", "p50_ms",
                                            "p99_ms")}}
        summary.update({k: res[k] for k in ("throughput_rps", "p50_ms",
                                            "p99_ms")})
        print(f"   {arch} 602->256->{classes}: " + json.dumps(summary),
              flush=True)
        results[f"serve.{arch}"] = summary
        results[f"launches.{arch}"] = counts
        require(res["served"] == 64 and base["served"] == 64,
                f"{arch}: every request served")
        require(res["all_logits_finite"] and base["all_logits_finite"],
                f"{arch}: finite logits")
        want = {k: n * forwards for k, n in per_forward.items()}
        require({k: v for k, v in counts.items() if v} == want,
                f"{arch}: launches {counts} for {forwards} forwards, "
                f"expected {want}")


# ---------------------------------------------------------------------------
# training phases
# ---------------------------------------------------------------------------

def check_grads(torch, label, fn, plain, inputs, cot):
    """Gradients of ``fn`` (an autograd Function through the kernels)
    against autograd through the plain version, on the same inputs and
    output cotangent: within 1e-4 · max|ref| per input, and bitwise
    repeatable."""
    def grads(f):
        ins = [t.detach().clone().requires_grad_(True) for t in inputs]
        return torch.autograd.grad(f(*ins), ins, cot)
    g1, g2, ref = grads(fn), grads(fn), grads(plain)
    torch.cuda.synchronize()
    res = {"case": label, "inputs": []}
    ok = True
    for a, b, r in zip(g1, g2, ref):
        err = (a - r).abs().max().item() if r.numel() else 0.0
        scale = r.abs().max().item() if r.numel() else 0.0
        bitwise = torch.equal(a, b)
        good = bitwise and bool(torch.isfinite(a).all()) and \
            err <= 1e-4 * scale
        res["inputs"].append({"shape": list(a.shape), "max_abs_err": err,
                              "max_abs_ref": scale, "bitwise": bitwise})
        ok = ok and good
    res["ok"] = ok
    print("   " + json.dumps(res), flush=True)
    if not ok:
        failures.append(f"{label}: gradients {res['inputs']}")
    return res


def median_bwd_ms(torch, out, inputs, cot, flush) -> float:
    """Median device time of one backward through a kept graph."""
    return median_ms(torch, lambda: torch.autograd.grad(
        out, inputs, cot, retain_graph=True), flush)


def minibatch_block(torch, g, dev):
    """The inner block of one ``--batch 1024``, fanouts 5/5 mini-batch of
    the training sampler, and its int8 wire rows (``fetch_masked_wire``
    through a degree cache, as the trainer fetches them)."""
    from repro_torch.core import caching as CA
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.core.sampling import NeighborSampler
    seeds = np.random.default_rng(2).choice(g.num_nodes, MB_BATCH,
                                            replace=False)
    mb = NeighborSampler(g, [5, 5], seed=2).sample(seeds)
    store = CA.FeatureStore(g, CA.degree_cache(g, g.num_nodes // 10),
                            codec="int8")
    src = mb.blocks[0].src_nodes
    wire = store.fetch_masked_wire(src, src >= 0)
    q, mn, scale = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in wire)
    return DeviceGraph.from_block(mb.blocks[0], dev), q, mn, scale


def gat_backward_case(torch, c, dg, heads, hd, *, timed):
    """The GAT backward (K1 over the src layout with an (E, heads)
    coefficient, K6 with ``heads``, three K2s) from the forward's saved
    ``(m, l)``, against autograd through the plain forward; timed, its
    plain version is that autograd backward."""
    from repro_torch.kernels import gat_fused as gf
    N, E, nnz = dg.num_src, dg.edge_src.numel(), int(dg.order.numel())
    src, dst, order, row_ptr = dg.edge_src, dg.edge_dst, dg.order, dg.row_ptr
    F = heads * hd
    hs, es, ed, gout = (c.randn(N, F), c.randn(N, heads), c.randn(N, heads),
                        c.randn(N, F))
    _, m, l = gf.gat_attention_cuda(hs, es, ed, src, order, row_ptr, N,
                                    stats=True)
    bwd_args = (gout, hs, es, ed, m, l, src, dst, dg.edge_mask, order,
                row_ptr, dg.src_layout)
    b1 = gf.gat_attention_backward(*bwd_args)
    b2 = gf.gat_attention_backward(*bwd_args)
    ins = [t.detach().clone().requires_grad_(True) for t in (hs, es, ed)]
    out_p = gf.gat_attention_plain(*ins, src, order, row_ptr, N)
    refs = torch.autograd.grad(out_p, ins, gout, retain_graph=True)
    errs = [(a - r).abs().max().item() for a, r in zip(b1, refs)]
    scales = [r.abs().max().item() for r in refs]
    bitwise = all(torch.equal(a, b) for a, b in zip(b1, b2))
    res = {"case": f"GAT backward, {heads} x {hd} ({E} edges)",
           "max_abs_err": max(errs), "max_abs_ref": max(scales),
           "errs": errs, "bitwise_repeatable": bitwise}
    if timed:
        # read g, hs, es, ed, m, l, the edge lists and both layouts once;
        # write dhs, des, ded once
        res["ms"] = median_ms(torch, lambda: gf.gat_attention_backward(
            *bwd_args), c.flush)
        res["plain_ms"] = median_bwd_ms(torch, out_p, ins, gout, c.flush)
        res["library_ms"] = None
        res["bound_ms"], res["bound_by"] = bound(
            4 * (3 * N * F + 6 * N * heads) + 9 * E + 8 * nnz + 8 * (N + 1),
            nnz * (4 * F + 20 * heads))
    res["ok"] = bitwise and all(e <= 1e-4 * s for e, s in zip(errs, scales))
    print("   " + json.dumps(res), flush=True)
    if not res["ok"]:
        failures.append(f"GAT backward {heads} x {hd}: errs {errs}, "
                        f"bitwise {bitwise}")
    return res, (hs, es, ed, gout)


@phase("5. training kernels and autograd Functions vs plain versions")
def phase_train_kernels(torch, g, g_gat, results):
    """``g`` is the 41-class graph GCN, SAGE and GIN train on, ``g_gat``
    the 40-class graph GAT trains on."""
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.kernels import gat_fused as gf
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as ss
    c = Checker(torch, seed=5)
    dev, flush, randn = c.dev, c.flush, c.randn
    dg = DeviceGraph.from_graph(g, dev, src_layout=True)
    N, E = g.num_nodes, dg.edge_src.numel()
    src, dst, order, row_ptr = dg.edge_src, dg.edge_dst, dg.order, dg.row_ptr
    order_s, row_ptr_s = dg.src_layout
    nnz = int(order.numel())
    U_src, U_dst = int(src.unique().numel()), int(dst.unique().numel())
    print(f"   full graph: {N} nodes, {E} edges ({nnz} listed), "
          f"{U_src} distinct sources, {U_dst} distinct destinations")

    coef = torch.rsqrt(dg.out_deg)[src.long()] * \
        torch.rsqrt(dg.in_deg)[dst.long()]
    mask = dg.edge_mask.to(torch.float32)
    # the forward kernels over the whole graph's dst layout: SAGE's layer
    # 0 (602 wide, the mask as coefficient), GCN's layer 0 and SAGE's
    # layer 1 (256), GCN's layer 1 (41)
    results["k1.full.602"] = c.k1(
        f"K1 full graph, SAGE layer 0 (F {FEAT})", randn(N, FEAT), src, mask,
        order, row_ptr, N)
    for F in (HIDDEN, CLASSES):
        results[f"k1.full.{F}"] = c.k1(
            f"K1 full graph, F {F}", randn(N, F), src, coef, order,
            row_ptr, N)
    # the transposes: K1 over the src layout, gathering through edge_dst,
    # at GCN's widths and with the GAT backward's (E, 4) coefficients
    for F in (HIDDEN, CLASSES):
        results[f"k1_transpose.{F}"] = c.k1(
            f"K1 over the src layout, GCN F={F} ({N} sources)",
            randn(N, F), dst, coef, order_s, row_ptr_s, N, transpose=True)
    # GAT's kernels on its own graph
    dga = DeviceGraph.from_graph(g_gat, dev, src_layout=True)
    Ea, nnz_a = dga.edge_src.numel(), int(dga.order.numel())
    print(f"   GAT's graph: {g_gat.num_nodes} nodes, {Ea} edges ({nnz_a} "
          f"listed)")
    alpha = torch.rand((Ea, GAT_HEADS), generator=c.gen).to(dev) * \
        dga.edge_mask[:, None].to(torch.float32)
    for F in (HIDDEN, GAT_CLASSES):
        results[f"k1_transpose.4x{F // GAT_HEADS}"] = c.k1(
            f"K1 over the src layout, 4 heads x {F // GAT_HEADS}",
            randn(N, F), dga.edge_dst, alpha, *dga.src_layout, N,
            transpose=True)
    # K2: GIN's layer-0 and layer-1 sums, the Scatter's transpose (src
    # layout), the GAT backward's 4-wide sums over either layout
    for F in (FEAT, HIDDEN):
        results[f"segment_sum.full.{F}"] = c.k2(
            f"K2 full graph, GIN ({E} x {F} -> {N})",
            randn(E, F) * mask[:, None], dst, order, row_ptr, N)
    results["segment_sum.src.256"] = c.k2(
        f"K2 over the src layout ({E} x {HIDDEN} -> {N})",
        randn(E, HIDDEN) * mask[:, None], src, order_s, row_ptr_s, N)
    for seg, (o, rp), what in ((dga.edge_dst, dga.layout, "dst"),
                               (dga.edge_src, dga.src_layout, "src")):
        c.k2(f"K2 over GAT's {what} layout ({Ea} x {GAT_HEADS} -> {N})",
             randn(Ea, GAT_HEADS) * dga.edge_mask[:, None].to(torch.float32),
             seg, o, rp, N)
    # K5: GIN's layer-0 Scatter (602 wide: float2 loads), its layer-1
    # Scatter and K2's backward (256 wide: float4 loads)
    results["gather_rows.602"] = c.k5(
        f"K5 gather ({E} x {FEAT})", randn(N, FEAT), src, order, E)
    results["gather_rows"] = c.k5(
        f"K5 gather ({E} x {HIDDEN})", randn(N, HIDDEN), dst, order, E)
    # K3 over the whole graph at GAT's two layers
    for heads, hd in ((GAT_HEADS, HIDDEN // GAT_HEADS),
                      (GAT_HEADS, GAT_CLASSES // GAT_HEADS)):
        results[f"gat_attention.full.{heads}x{hd}"] = c.k3(
            f"K3 GAT's full graph, {heads} x {hd}", dga, heads, hd)
    # K6: the reference's single-head edge dot (K1's dcoef) and the GAT
    # backward's dalpha at its two layers
    for heads, hd, gr in ((1, HIDDEN, dg), (GAT_HEADS, HIDDEN // GAT_HEADS,
                                            dga),
                          (GAT_HEADS, GAT_CLASSES // GAT_HEADS, dga)):
        F = heads * hd
        a, b = randn(N, F), randn(N, F)
        o, gs, gd = gr.order, gr.edge_src, gr.edge_dst
        n_l = int(o.numel())
        us = int(gs[o.long()].unique().numel())
        ud = int(gd[o.long()].unique().numel())
        lib = None
        if heads == 1:
            S_csr = torch.sparse_csr_tensor(
                gr.row_ptr.long(), gs[o.long()].long(),
                torch.ones(n_l, device=dev), size=(N, N))
            lib = lambda: torch.sparse.sampled_addmm(S_csr, b, a.t(),
                                                     beta=0.0)
        results[f"edge_dot.{heads}x{hd}"] = check_case(
            torch, f"K6 edge dot, {heads} x {hd} ({gs.numel()} edges)",
            ss.edge_dot_cuda, ss.edge_dot_plain,
            (a, b, gs, gd, o, heads), timed=True, library=lib,
            bytes_=4 * (us * F + ud * F + n_l * heads) + 12 * n_l,
            flops=2 * n_l * F, flush=flush)
    results["edge_dot"] = results[f"edge_dot.1x{HIDDEN}"]

    blk, q, mn, scale = minibatch_block(torch, g, dev)
    bnnz = int(blk.order.numel())
    bU = _distinct_src(blk)
    print(f"   batch-{MB_BATCH} inner block: {blk.num_src} x {FEAT} uint8 "
          f"rows -> {blk.num_dst}, {blk.edge_src.numel()} slots, {bnnz} "
          f"valid")
    results["gather_scale_segment_sum_q"] = check_case(
        torch, f"K4 int8-in ({blk.num_src} x {FEAT} -> {blk.num_dst})",
        ss.gather_scale_segment_sum_q_cuda,
        ss.gather_scale_segment_sum_q_plain,
        (q, mn, scale, blk.edge_src, blk.edge_mask.to(torch.float32),
         blk.order, blk.row_ptr, blk.num_dst), timed=True,
        bytes_=bU * FEAT + 8 * bU + 4 * blk.num_dst * FEAT + 12 * bnnz,
        flops=4 * bnnz * FEAT, flush=flush)

    # the GAT backward at both layers' shapes; the 4 x 64 case is timed
    results["gat_backward"], (hs, es, ed, gout) = gat_backward_case(
        torch, c, dga, GAT_HEADS, HIDDEN // GAT_HEADS, timed=True)
    gat_backward_case(torch, c, dga, GAT_HEADS, GAT_CLASSES // GAT_HEADS,
                      timed=False)

    # each autograd Function against autograd through its plain version
    h, cf = randn(N, HIDDEN), coef.clone()
    check_grads(torch, "K1 Function (dh by K1 transpose, dcoef by K6)",
                lambda h, c: ops.GatherScaleSegmentSum.apply(
                    h, src, dst, c, order, row_ptr, dg.src_layout, N),
                lambda h, c: ss.gather_scale_segment_sum_plain(
                    h, src, c, order, row_ptr, N), [h, cf], randn(N, HIDDEN))
    check_grads(torch, "K2 Function (dmsgs by K5)",
                lambda m: ops.SegmentSum.apply(m, dst, order, row_ptr, N),
                lambda m: ss.segment_sum_plain(m, order, row_ptr, N),
                [randn(E, HIDDEN)], randn(N, HIDDEN))
    check_grads(torch, "Scatter gather Function (dx by K2 over src layout)",
                lambda x: ops.GatherRows.apply(x, src, order, dg.src_layout),
                lambda x: ss.gather_rows_plain(x, src, order, E),
                [randn(N, HIDDEN)], randn(E, HIDDEN))
    check_grads(torch, "K3 Function (the GAT VJP)",
                lambda a, b, c: ops.GatAttention.apply(
                    a, b, c, dga.edge_src, dga.edge_dst, dga.edge_mask,
                    dga.order, dga.row_ptr, dga.src_layout, N),
                lambda a, b, c: gf.gat_attention_plain(
                    a, b, c, dga.edge_src, dga.order, dga.row_ptr, N),
                [hs, es, ed], gout)


def train_args(arch, classes, extra=()):
    return ["--arch", arch, "--nodes", str(NODES), "--classes", str(classes),
            "--feat-dim", str(FEAT), "--hidden", str(HIDDEN), "--device",
            "cuda", *extra]


def _expected(arch, epochs):
    want = {k: v * epochs for k, v in STEP_LAUNCHES[arch].items()}
    for k, v in EVAL_LAUNCHES[arch].items():
        want[k] = want.get(k, 0) + v
    return want


def _params_equal(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                  b.parameters()))


@phase("6. full-batch training at Reddit widths")
def phase_fullbatch(torch, results):
    from repro_torch.kernels import ops
    from repro_torch.launch import train_gnn
    for arch in ("gcn", "sage", "gin", "gat"):
        classes = GAT_CLASSES if arch == "gat" else CLASSES
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = train_gnn.main(train_args(arch, classes, [
            "--epochs", str(TRAIN_EPOCHS)]))
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = res["losses"]
        summary = {"losses": losses, "epoch_ms": [s * 1e3 for s in
                                                  res["epoch_s"]],
                   "median_epoch_ms": float(np.median(res["epoch_s"][1:]))
                   * 1e3, "setup_s": res["setup_s"],
                   "accuracy": res["accuracy"], "launches": counts,
                   "max_memory_allocated": peak, "wall_s": wall}
        print(f"   {arch} 602->256->{classes}: " + json.dumps(summary),
              flush=True)
        results[f"train.{arch}"] = summary
        results[f"launches.train.{arch}"] = counts
        require(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
                f"{arch}: finite, falling loss {losses}")
        want = _expected(arch, TRAIN_EPOCHS)
        require(counts == want, f"{arch}: launches {counts}, by design "
                f"{want}")
        _repeat_and_cpu_step(torch, arch, classes, res, results)
        if arch == "gcn":
            _profile_gcn_step(torch, res["graph"], results)


def _repeat_and_cpu_step(torch, arch, classes, res, results):
    """A second run from the same init, through the train step itself,
    must end in bitwise-equal parameters; then one step's gradients on
    the card against the same step on the CPU."""
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.models.gnn import model as GM
    from repro_torch.optim import AdamW
    g = res["graph"]
    cfg = GM.GNNConfig(arch=arch, feat_dim=FEAT, hidden=HIDDEN,
                       num_classes=classes)
    dev = torch.device("cuda")
    dg = DeviceGraph.from_graph(g, dev, src_layout=True)
    x = torch.from_numpy(g.features).to(dev)
    y = torch.from_numpy(g.labels).to(dev)
    mask = torch.ones(y.shape, device=dev)
    model = GM.init_gnn(cfg, torch.Generator().manual_seed(0), device=dev)
    step = GM.make_fullgraph_train_step(
        cfg, AdamW(model.parameters(), lr=1e-2, weight_decay=0.0))
    for _ in range(TRAIN_EPOCHS):
        step(model, dg, x, y, mask)
    torch.cuda.synchronize()
    same = _params_equal(torch, model, res["model"])
    print(f"   {arch}: second run from the same init bitwise equal: {same}",
          flush=True)
    require(same, f"{arch}: two runs end in bitwise-equal parameters")

    grads = {}
    for d in ("cuda", "cpu"):
        m = GM.init_gnn(cfg, torch.Generator().manual_seed(0), device=d)
        gd, xd = dg, x
        if d == "cpu":
            # the CPU step runs in float64, so its own rounding (sums over
            # 232 965 rows in another order) drops out of the comparison
            m = m.double()
            gd = DeviceGraph.from_graph(g, "cpu", src_layout=True)
            xd = x.cpu().double()
        loss = GM.nll_loss(GM.forward_full(cfg, m, gd, xd), y.to(d))
        loss.backward()
        grads[d] = [p.grad.detach().cpu().double() for p in m.parameters()]
    # held to 1e-4 of the model's largest gradient: a float32 sum over
    # 232 965 rows can miss its own parameter's max by about 1e-4
    # (SAGE's and GIN's layer-0 weights), the errors are printed per
    # parameter
    top = max(b.abs().max().item() for b in grads["cpu"])
    errs = []
    for (name, _), a, b in zip(m.named_parameters(), grads["cuda"],
                               grads["cpu"]):
        err = (a - b).abs().max().item()
        errs.append({"param": name, "err": err,
                     "max_abs_cpu": b.abs().max().item()})
        require(err <= 1e-4 * top, f"{arch} {name}: gradient cuda vs cpu "
                f"{err}, model's max |grad| {top}")
    print(f"   {arch}: one step's gradients, cuda vs cpu (float64; model's "
          f"max |grad| {top:.6g}): " + json.dumps(errs), flush=True)
    results[f"train.{arch}"]["grad_cuda_vs_cpu"] = errs


def _profile_gcn_step(torch, g, results):
    """One full-batch GCN training step under ``torch.profiler``: device
    time split into the port's kernels, matrix products, copies and the
    rest (elementwise, the optimizer); beside it, CUDA-event times of the
    step's two 602-wide products (the forward ``x @ w`` and the weight
    gradient ``x^T @ dh``), each 72 GFLOP.  The step is profiled twice:
    alone in a profiling session, and as the active step of a session
    that first profiles one warm-up step (``torch.profiler.schedule``):
    alone, the session misses the step's first device work."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.models.gnn import model as GM
    from repro_torch.optim import AdamW
    dev = torch.device("cuda")
    cfg = GM.GNNConfig(arch="gcn", feat_dim=FEAT, hidden=HIDDEN,
                       num_classes=CLASSES)
    dg = DeviceGraph.from_graph(g, dev, src_layout=True)
    x = torch.from_numpy(g.features).to(dev)
    y = torch.from_numpy(g.labels).to(dev)
    mask = torch.ones(y.shape, device=dev)
    model = GM.init_gnn(cfg, torch.Generator().manual_seed(0), device=dev)
    step = GM.make_fullgraph_train_step(
        cfg, AdamW(model.parameters(), lr=1e-2, weight_decay=0.0))
    for _ in range(3):
        step(model, dg, x, y, mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    float(step(model, dg, x, y, mask))
    wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def kind(key):
        k = key.lower()
        if any(n in k for n in ("segmented_rows", "gather_rows_kernel",
                                "edge_dot_kernel", "gat_attention_kernel")):
            return "port kernels"
        if any(n in k for n in ("gemm", "gemv", "cutlass", "xmma", "sm90_",
                                "sm80_", "ampere_", "volta_", "matmul",
                                "nvjet", "splitk")):
            return "matrix products"
        if k.startswith(("memcpy", "memset")):
            return "copies"
        return "other"

    profiles = {}
    for label, warmup in (("alone", 0), ("after a warm-up step", 1)):
        for _ in range(2):         # the first session pays CUPTI's start-up
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=warmup, active=1,
                                           repeat=1) if warmup else None
                         ) as prof:
                for _ in range(warmup + 1):
                    float(step(model, dg, x, y, mask))
                    prof.step()
        # device-side kernels and copies; GPU ranges of user annotations
        # (the optimizer's step) overlap the kernels inside them
        rows = [e for e in prof.key_averages()
                if e.device_type != DeviceType.CPU and dev_us(e) > 0
                and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith("Optimizer.")]
        split = {"port kernels": 0.0, "matrix products": 0.0, "copies": 0.0,
                 "other": 0.0}
        for e in rows:
            split[kind(e.key)] += dev_us(e) / 1e3
        total = sum(split.values())
        listing = [{"kernel": e.key, "kind": kind(e.key), "count": e.count,
                    "ms": dev_us(e) / 1e3}
                   for e in sorted(rows, key=dev_us, reverse=True)]
        print(f"   GCN step profiled {label}: wall {wall_ms:.3f} ms, device "
              f"{total:.3f} ms ({total / wall_ms:.2%} busy), "
              f"{sum(e.count for e in rows)} device events; split (ms): "
              + json.dumps(split), flush=True)
        for r in listing[:12]:
            print(f"   {r['ms']:9.3f} ms  x{r['count']:<3d} {r['kind']:15s} "
                  f"{r['kernel'][:80]}")
        profiles[label] = {"device_ms": total, "split_ms": split,
                           "kernels": listing}
    flush = torch.empty(64 * 2**20 // 4, device=dev)
    w0 = model[0].w.detach()
    dh0 = torch.randn((g.num_nodes, HIDDEN),
                      generator=torch.Generator().manual_seed(3)).to(dev)
    gflop = 2 * g.num_nodes * FEAT * HIDDEN / 1e9
    fwd_ms = median_ms(torch, lambda: x @ w0, flush)
    wgrad_ms = median_ms(torch, lambda: x.t() @ dh0, flush)
    print(f"   layer-0 products by CUDA events: x @ w {fwd_ms:.3f} ms, "
          f"x^T @ dh {wgrad_ms:.3f} ms ({gflop:.1f} GFLOP each: "
          f"{gflop / fwd_ms:.1f} and {gflop / wgrad_ms:.1f} TFLOP/s)",
          flush=True)
    results["profile.gcn"] = {"wall_ms": wall_ms, "profiles": profiles,
                              "x_w_ms": fwd_ms, "xT_dh_ms": wgrad_ms,
                              "gflop_each": gflop}


@phase("7. mini-batch GraphSAGE at Reddit widths, fp32 and int8")
def phase_minibatch(torch, results):
    from repro_torch.kernels import ops
    from repro_torch.launch import train_gnn
    for codec in ("fp32", "int8"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = train_gnn.main(train_args("sage", CLASSES, [
            "--minibatch", "--batch", str(MB_BATCH), "--epochs", "1",
            "--cache", "degree", "--wire-codec", codec,
            *(["--use-kernel"] if codec == "int8" else [])]))
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        losses, steps = res["losses"], res["steps"]
        summary = {"steps": steps, "wall_s": time.perf_counter() - t0,
                   "median_step_ms": float(np.median(res["step_s"])) * 1e3,
                   "p90_step_ms": float(np.percentile(res["step_s"], 90))
                   * 1e3,
                   "cache_hit_ratio": res["cache_hit_ratio"],
                   "fetched_mib": res["fetched_bytes"] / 2**20,
                   "loss_first10": float(np.mean(losses[:10])),
                   "loss_last10": float(np.mean(losses[-10:])),
                   "launches": counts}
        print(f"   minibatch sage {codec}: " + json.dumps(summary),
              flush=True)
        results[f"minibatch.{codec}"] = summary
        results[f"launches.minibatch.{codec}"] = counts
        require(bool(np.isfinite(losses).all())
                and summary["loss_last10"] < summary["loss_first10"],
                f"{codec}: finite, falling loss")
        k4 = counts.get("gather_scale_segment_sum_q", 0)
        require(k4 == (steps if codec == "int8" else 0),
                f"{codec}: K4 launched {k4} times in {steps} steps")
        # layer 0 (K4 under int8) and layer 1 forward, layer 1 backward
        want = {"gather_scale_segment_sum": steps * (1 if codec == "int8"
                                                     else 2),
                "gather_scale_segment_sum_t": steps}
        if codec == "int8":
            want["gather_scale_segment_sum_q"] = steps
        require(counts == want, f"{codec}: launches {counts}, by design "
                f"{want}")



def kernels_line(results) -> dict:
    """One row per kernel: its times from phase 2 or 5, its launches from
    the phase that trains through it (phases 6 and 7)."""
    rows = []
    meta = [("gather_scale_segment_sum", "gather_scale_segment_sum",
             "segment_sum.cu", "src/repro/kernels/segment_sum.py:345",
             "launches.train.gcn"),
            ("gather_scale_segment_sum_t", f"k1_transpose.{HIDDEN}",
             "segment_sum.cu", "src/repro/kernels/segment_sum.py:345",
             "launches.train.gcn"),
            ("segment_sum", "segment_sum", "segment_sum.cu",
             "src/repro/kernels/segment_sum.py:152", "launches.train.gin"),
            ("gat_attention", "gat_attention", "gat_fused.cu",
             "src/repro/kernels/gat_fused.py:163", "launches.train.gat"),
            ("gather_scale_segment_sum_q", "gather_scale_segment_sum_q",
             "segment_sum.cu", "src/repro/kernels/segment_sum.py:580",
             "launches.minibatch.int8"),
            ("gather_rows", "gather_rows", "segment_sum.cu",
             "src/repro/kernels/segment_sum.py:221", "launches.train.gin"),
            ("edge_dot", "edge_dot", "segment_sum.cu",
             "src/repro/kernels/segment_sum.py:411", "launches.train.gat")]
    for name, key, src, replaces, path in meta:
        r = results[key]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces,
            "launches": results[path].get(name, 0),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    return {"kernels": rows}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    from repro_torch import device as D
    D.resolve("cuda")
    smi = nvidia_smi_line()
    print(f"card: {smi} | torch.cuda.get_device_name: "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    results: dict = {}
    phase_build(torch)
    t0 = time.perf_counter()
    g = reddit_graph()
    blocks, x_np = sampled_blocks(g, FANOUTS)
    print(f"reddit-width graph: {g.num_nodes} nodes, {g.num_edges} edges "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    phase_kernels(torch, blocks, x_np, results)
    phase_serve(torch, results)
    phase_cpu_parity(torch, blocks, x_np)
    phase_profile(torch, blocks, x_np)
    phase_gin_gat(torch, results)
    phase_train_kernels(torch, g, reddit_graph(GAT_CLASSES), results)
    del blocks, x_np
    phase_fullbatch(torch, results)
    phase_minibatch(torch, results)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w",
              encoding="utf-8") as f:
        json.dump({"card": smi, "failures": failures,
                   "results": results}, f, indent=1,
                  default=str)
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), flush=True)
        return 1
    print(smi)
    print(json.dumps(kernels_line(results)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
