#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and
check it.  Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure makes the exit code nonzero:

1. the card (``nvidia-smi`` name and power limit); build the Hopper
   kernels from ``src/repro_torch/kernels/csrc`` and time the build;
2. each kernel (K1 gather-scale-segment-sum, K2 segment-sum, K3 GAT
   attention) at the full-width shapes of the GraphSAGE-Reddit serving
   path plus edge cases: max abs error against its plain PyTorch
   version (bound 1e-4 · max|plain|), bitwise repeatability, and the
   median over 25 timed launches (CUDA events around one launch queued
   behind a device sleep, L2 flushed before each) of the kernel, the
   plain version and, where one PyTorch call computes the same function,
   that call; beside the least time the card could take (bytes over
   3.35 TB/s, or flops over 67 TFLOP/s fp32);
3. serve GraphSAGE at Reddit's widths (602 → 256 → 41, fanouts 10/25,
   232 965 nodes) through ``repro_torch.launch.serve_gnn``: 256
   requests, throughput, p50/p99, the sample/forward span split; K1 must
   launch twice per forward; one bucket-64 batch of SAGE, GIN and GAT
   each on the card agrees with the CPU to 1e-4; ``torch.profiler``
   splits one SAGE forward's device time by kernel and copy;
4. serve GIN (602 → 256 → 41) and GAT (602 → 256 → 40: its output layer
   splits the classes over 4 heads, and 41 does not split) at Reddit's
   widths and fanouts, 64 requests each; K2 and K3 must launch twice per
   forward.

The last lines are the card's ``nvidia-smi`` line, one
``{"kernels": [...]}`` JSON line, and
``{"ok": true, "device": {...}}``.  Exits nonzero, printing no result,
when CUDA is not available.
"""
from __future__ import annotations

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
# each served path: (arch, classes, the kernel it aggregates with)
SERVED = (("sage", CLASSES, "gather_scale_segment_sum"),
          ("gin", CLASSES, "segment_sum"),
          ("gat", GAT_CLASSES, "gat_attention"))

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


def reddit_graph():
    from repro_torch.graph import generators as G
    g = G.sbm(NODES, CLASSES, p_in=0.9, p_out=0.02, seed=0)
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


@phase("2. kernels vs plain versions")
def phase_kernels(torch, blocks, x_np, results):
    from repro_torch.kernels import gat_fused, segment_sum as ss
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(0)
    flush = torch.empty(64 * 2**20 // 4, device=dev)     # > 50 MB L2
    inner, outer = blocks

    def k1(g, h, label, timed=False):
        coef = g.edge_mask.to(torch.float32)
        nnz = int(g.order.numel())
        U = _distinct_src(g)
        D, F = g.num_dst, h.shape[1]
        A = torch.sparse_csr_tensor(
            g.row_ptr.long(), g.edge_src[g.order.long()].long(),
            coef[g.order.long()], size=(D, h.shape[0]))
        return check_case(
            torch, label, ss.gather_scale_segment_sum_cuda,
            ss.gather_scale_segment_sum_plain,
            (h, g.edge_src, coef, g.order, g.row_ptr, D), timed=timed,
            library=lambda: torch.sparse.mm(A, h),
            bytes_=4 * (U * F + D * F) + 12 * nnz, flops=2 * nnz * F,
            flush=flush)

    def k2(g, F, label, timed=False):
        E = g.edge_src.numel()
        msgs = torch.randn((E, F), generator=gen).to(dev)
        msgs = msgs * g.edge_mask[:, None].to(msgs.dtype)
        nnz, D = int(g.order.numel()), g.num_dst
        seg = g.edge_dst.long()
        return check_case(
            torch, label, ss.segment_sum_cuda, ss.segment_sum_plain,
            (msgs, g.order, g.row_ptr, D), timed=timed,
            library=lambda: torch.zeros((D, F), device=dev).index_add_(
                0, seg, msgs),
            bytes_=4 * (nnz * F + D * F) + 8 * nnz, flops=nnz * F,
            flush=flush)

    def k3(g, heads, hd, label, timed=False):
        S, D = g.num_src, g.num_dst
        hs = torch.randn((S, heads * hd), generator=gen).to(dev)
        es = torch.randn((S, heads), generator=gen).to(dev)
        ed = torch.randn((D, heads), generator=gen).to(dev)
        nnz, U = int(g.order.numel()), _distinct_src(g)
        return check_case(
            torch, label, gat_fused.gat_attention_cuda,
            gat_fused.gat_attention_plain,
            (hs, es, ed, g.edge_src, g.order, g.row_ptr, D), timed=timed,
            bytes_=(4 * (U * heads * hd + D * heads * hd + U * heads
                         + D * heads) + 12 * nnz),
            flops=nnz * heads * (8 + 2 * hd), flush=flush)

    g_in, g_out = _dev_graph(torch, inner, dev), _dev_graph(torch, outer, dev)
    g_full = _dev_graph(torch, inner, dev, all_valid=True)
    x = torch.from_numpy(x_np).to(dev)
    h1 = torch.randn((g_out.num_src, HIDDEN), generator=gen).to(dev)
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
    results["gat_attention"] = k3(g_in, 4, HIDDEN // 4, "K3 inner sampled "
                                  "(18304x4x64 -> 1664)", timed=True)
    results["gat_attention.full"] = k3(g_full, 4, HIDDEN // 4,
                                       "K3 every slot valid", timed=True)
    # the other shapes the served paths feed the kernels: GIN's layer 1
    # (F 256: float4 loads), GAT's 40-class output layer (4 x 10), and
    # the launcher's default widths (F 32 and 64, 4 x 16, 4 x 1)
    k2(g_out, HIDDEN, "K2 GIN layer 1 sampled (1600x256 -> 64)")
    k3(g_out, GAT_HEADS, GAT_CLASSES // GAT_HEADS,
       "K3 outer, 4 heads of width 10")
    k2(g_in, 32, "K2 inner, F=32")
    k2(g_out, 64, "K2 outer, F=64")
    k3(g_in, 4, 16, "K3 inner, 4 heads of width 16")
    k3(g_out, 4, 1, "K3 outer, 4 heads of width 1")
    for E, masked, what in [(0, False, "E=0"), (40, True, "all masked")]:
        tg = _tiny_graph(dev, 30, 20, E, masked)
        k1(tg, torch.randn((30, 37), generator=gen).to(dev), f"K1 {what}")
        k2(tg, 5, f"K2 {what}")
        k3(tg, 4, 3, f"K3 {what}")
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
        *map(str, FANOUTS), "--requests", "256", "--device", "cuda"])
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
    require(res["served"] == 256 and base["served"] == 256,
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
    for arch, classes, kernel in SERVED[1:]:
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
        require(counts[kernel] == 2 * forwards
                and sum(counts.values()) == counts[kernel],
                f"{arch}: only {kernel}, twice per forward: {counts}, "
                f"{forwards} forwards")


def kernels_line(results) -> dict:
    rows = []
    meta = [("gather_scale_segment_sum", "segment_sum.cu",
             "src/repro/kernels/segment_sum.py:345", "launches.sage"),
            ("segment_sum", "segment_sum.cu",
             "src/repro/kernels/segment_sum.py:152", "launches.gin"),
            ("gat_attention", "gat_fused.cu",
             "src/repro/kernels/gat_fused.py:163", "launches.gat")]
    for name, src, replaces, path in meta:
        r = results[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": replaces,
            "launches": results[path][name],
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
