#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and
check it.  Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure makes the exit code nonzero:

1. the card (``nvidia-smi`` name and power limit); build the Hopper
   kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, all in parallel) and time the build; ptxas's registers and
   spills per kernel, and the ``HGMMA`` instructions in each K7 kernel's
   SASS and in K8's (``cuobjdump -sass``: nonzero in each of the eight K7
   kernels, bf16 and float32 at every head width, and in K8's two bf16
   kernels, N 64 and 128, with no spills in any of them); each
   ``launch_plan``'s shared memory equals what its kernel asks for;
2. each forward kernel (K1 gather-scale-segment-sum, K2 segment-sum, K3
   GAT attention) at the full-width shapes of the GraphSAGE-Reddit
   serving path plus edge cases: max abs error against its plain PyTorch
   version (bound 1e-4 · max|plain|), bitwise repeatability, and the
   median over 25 timed launches (CUDA events around one launch queued
   behind a device sleep, L2 flushed before each) of the kernel, the
   plain version and, where one PyTorch call computes the same function,
   that call; beside the least time the card could take (bytes over
   3.35 TB/s, or flops over 67 TFLOP/s fp32) and, for K1, K3 and K4,
   the gather bound (every listed edge's row, the output and the indices
   over 3.35 TB/s: what a graph whose sources lie anywhere allows);
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
   41, and 4 heads x 64 and x 10 with the column it also sums in GAT's
   VJP), K2 (602, 256; either layout), K5 (602 wide over the src layout,
   as GIN's Scatter walks it, and over the dst layout; 256 wide), K3 (4 x
   64, 4 x 10) and K6 (1 x 256, the single-head dcoef; 4 x 64 and 4 x
   10) on GAT's 40-class graph, K4 on the int8 rows of a batch-1024
   block, K3's VJP (its destination pass, then K1 over the src layout)
   at both layers; and each autograd Function's gradients (K1, K2, the
   Scatter gather, K3) against autograd through the plain versions;
6. full-batch training at Reddit's widths through
   ``repro_torch.launch.train_gnn``: GCN, SAGE, GIN (602 → 256 → 41) and
   GAT (→ 40), 10 epochs each: the loss is finite and falls, every step
   launches exactly the kernels of its design and nothing plain, a second
   run from the same init ends in bitwise-equal parameters, one step's
   gradients on the card agree with the same step on the CPU (in
   float64) to 1e-4 of the model's largest gradient; ms per epoch, peak
   device memory, a ``torch.profiler`` split of one GCN step and of one
   GAT step by kernel, matrix product and copy (alone in a profiling
   session, and after a profiled warm-up step), and CUDA-event times of
   GCN's two large products;
7. mini-batch GraphSAGE at Reddit's widths: ``--batch 1024 --epochs 1
   --cache degree`` with ``--wire-codec fp32`` and then ``int8
   --use-kernel`` for 60 of the epoch's 227 steps (``train_gnn.run``'s
   ``steps_per_epoch``; wire rows into K4); K4 launches once per int8
   step and never under fp32; step time, cache hit ratio, fetched MiB and the loss trend;
11. (run after phase 7) locality reordering, the dataset registry, the
   importance and layer-wise samplers and a changing graph, at Reddit's
   widths: (a) for each reorder policy (none, degree, bfs, rcm) the 41-
   and 40-class graphs packed (host seconds, ``locality_report``), then
   phase 5's whole-graph cases of K1 (602, 256, 41), K1ᵀ (256), K3 and
   its VJP (4 x 64) and K5 (602, src layout) on them, checked and timed
   as in phase 5, one line a policy beside phase 5's times; (b)
   full-batch SAGE and GAT under ``--reorder bfs`` and ``rcm``: phase 6's
   launches, each epoch's loss within 1e-4 (relative) of phase 6's, and
   phase 6's predictions but for near ties; (c) SAGE served under
   ``--reorder bfs``: every request answered in the workload's original
   ids, K1 twice a forward; (d) SAGE served with ``--update-stream`` (a
   stream of 2 000 synthesized events written to ``chiprun_out/``): every
   event folded, then the updated server against a cold one built on the
   folded graph within 1e-5; (e) mini-batch SAGE with ``--sampler
   importance`` (over a sixteenth of the nodes), ``fastgcn`` and
   ``ladies``: falling loss, K1's launches as phase 7's fp32 run, K1's
   plan searches and host time a launch; (f) ``train_gnn --dataset
   pubmed-like`` (GCN) and ``serve_gnn --dataset reddit-like`` (SAGE);
12. (run after phase 11) phase 3's SAGE served through the replicated
   tier (``serve_gnn --replicas``, ``repro_torch.serving.ReplicaRouter``):
   (a) 2 replicas under ``least_queue`` and ``round_robin``, 256 requests
   at 2 000 req/s, then 32 of the nodes phase 3 served asked of the same
   router, within 1e-5 of phase 3's largest logit; (b) ``--replicas 1
   --autoscale --rate 8000``, 512 requests: at least one scale-up; (c)
   ``--hot-swap-every 64 --ckpt-dir`` then a second run resuming the
   saved version, the restored weights bitwise equal to the saved ones
   and 32 nodes' answers under them bitwise equal; (d) ``--update-stream``
   on phase 11(d)'s stream, every event folded, a replica against a cold
   server on the folded graph within 1e-5.  In every run: zero drops and
   torn batches, K1 twice a forward across the fleet (warmups and reaped
   replicas included); req/s, p50 and p99 are virtual-clock numbers (the
   replicas run one after another on the card, so N replicas model N
   cards);
8. K7 (flash attention) and K8 (the Mamba2 SSD chunk state) against their
   plain versions, checked and timed as in phase 2 (K7's bf16 outputs,
   from the tensor-core route, element by element within one bf16 ulp
   of the plain value, 2**-7 of it, plus 2**-8 of the plain version on
   |v| for P rounded to bf16, plus 1e-5 of the largest, with the worst
   excess over the bound without the P term printed beside; bound by
   bytes or by flops over the tensor-core peak of the inputs' type, 989
   TFLOP/s in bf16, 495 TFLOP/s in TF32 for float32; the
   library yardsticks are ``scaled_dot_product_attention`` and the
   reference's einsum): first hd 64, 96, 128 and 256, a non-causal call
   and a window of 40 (untimed), then K7 at Phi-3-mini's prefill (8 x
   1024, 32 x 96, causal) in bf16 and float32 (the TF32 split route),
   with G 5 at hd 128, a window of 256, Sq < Skv and Sq 1, each also in
   float32 (1e-4 of the largest value), and at phase 13's three prefill
   shapes (8 x 1024: Qwen2.5-14B 40 / 8 x 128, Gemma-7B 16 / 16 x 256,
   GLM-4-9B 32 / 2 x 128; timed in bf16, checked in float32); K8 at Mamba2-780m's prefill (32
   chunks of 256, 48 x 64, N 128) in bf16 (the tensor-core route, 1e-4
   of the largest value) with G 1 and 2 and in float32 (the CUDA-core
   route), and in bf16 at ragged chunks of 100 and 7 positions and over
   160 chunks; K8 at Zamba2-2.7B's widths (80 x 64, N 64: the
   tensor-core route's N 64 kernel), and bf16 off the tensor-core tile
   (the reduced configs' 8 x 32, N 16, chunk 16, timed; a chunk of 300)
   on the CUDA-core route; the calls K7 does not compute raise on the
   card;
9. serve Phi-3-mini-3.8B at its published widths in bf16: (a) the
   serving launcher ``repro_torch.launch.serve`` (8 x 64 prompt tokens
   through the decode-only loop, 32 generated), tok/s and peak memory, no
   K7 launch; (b) ``prefill`` of 8 x 1024 tokens and 32 decode steps in
   its cache (grown by 32 slots), exactly 32 K7 launches (bf16 route;
   the float32 prefill below, 32 of the float32 route), finite logits,
   prefill against the decode-only loop over the same prompts at full
   depth in float32 (within 1e-3 of the largest logit; Mamba2 3e-3) and
   in bf16 (RMS ratio bound), prefill and decode tok/s, peak memory; (c)
   a ``torch.profiler`` split of one prefill and of one decode step (K7,
   matrix products, elementwise work) as the active step after a
   profiled warm-up step; (d) a 2-layer float32 cut at full width on the
   card and on the CPU: forward, prefill and decode logits within 1e-4
   of the largest;
10. serve Mamba2-780m the same way, with exactly 48 K8 launches per
   prefill (bf16 route; its float32 prefill, 48 of the float32 route);
13. serve Qwen2.5-14B, Gemma-7B and GLM-4-9B one after another (each
   freed before the next) at their published widths and full depth in
   bf16, random weights: a prefill of 8 x 1024 with exactly one K7 launch
   (bf16 route) a layer, 32 decode steps in its grown cache, finite
   logits, tok/s and peak memory; float32 prefill against the decode-only
   loop on a 4-layer cut at full width (1e-3 of the largest logit, K7's
   float32 route once a layer); a 2-layer float32 cut on the card and the
   CPU as in 9(d).  Full depth in float32 is left out: Qwen2.5-14B's
   float32 weights (about 59 GB) do not fit beside the rest;
14. (run last) distributed full-graph GCN at Reddit's widths (602 → 256
   → 41, hash partitioner) with 4 ranks sharing the card: one spawned
   world (``train_gnn.run_world``: gloo, CUDA tensors staged through
   pinned host buffers) runs every job in turn: (a) ``--devices 4 --mode
   pull`` (twice: bitwise equal), ``push``, ``stale`` and ``hysync`` (S 3),
   10 AdamW epochs each: pull against phase 6's GCN, the other modes
   against pull (the first 4 losses within 1e-4, the parameters within
   ``DIST_ADAMW_PARAM_TOL``), beside float32's own error (phase 6's run
   and pull against the same GCN in float64 through the plain versions
   on the card) and two wrong paths (pull with its gathered rows in
   bf16, pull without one rank's gradient), which must exceed the
   bound; every synchronous mode and async S 0 under 10 SGD steps
   against the card's single-card GCN within 1e-5; every rank's
   parameters bitwise equal; (b) every rank launches K1 and K1ᵀ exactly
   once an epoch each at 256 and at 41 columns (the wrapper counts by
   width), nothing else (rank 0 one K1 more at each width for
   ``--fullgraph``'s accuracy); (c) ``parameter_server_update`` against
   ``allreduce_update`` within 1e-5; (d) ``--fullgraph`` at S 0, 1, 4
   (fp32) and S 1 (int8): bytes per step fall with S, int8 moves
   at most 0.35 of fp32's within 5 % of its loss, every rank's ghost
   planes bitwise equal; phase 11(d)'s 2 000 events folded over 5
   epochs; (e) ms an epoch split into the collectives (staging + gloo
   wait) and the rest, CUDA-event spans, bytes a rank an epoch; K1 and
   K1ᵀ at rank 0's pull (N_pad → n_local) and push (n_local → N_pad)
   shapes against their bounds and ``torch.sparse.mm``.

The last lines are the card's ``nvidia-smi`` line, one
``{"kernels": [...]}`` JSON line, and
``{"ok": true, "device": {...}}``.  Exits nonzero, printing no result,
when CUDA is not available.
"""
from __future__ import annotations

import functools
import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12           # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12          # bf16 tensor cores, dense
TF32_FLOPS_PER_S = 495e12          # TF32 tensor cores, dense
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
    "gat": {"gat_attention": 2, "gat_attention_backward": 2,
            "gather_scale_segment_sum_t": 2},
}
# the launches of the forward that measures the final accuracy
EVAL_LAUNCHES = {"gcn": {"gather_scale_segment_sum": 2},
                 "sage": {"gather_scale_segment_sum": 2},
                 "gin": {"gather_rows": 2, "segment_sum": 2},
                 "gat": {"gat_attention": 2}}
MB_BATCH = 1024
# phase 7's int8 run: a fixed number of steps (reduced from the epoch's
# 227: a step is ~0.37 s of host encoding, and phase 14 needs the time)
MB_INT8_STEPS = 60

failures: list = []
# phase 6's trained SAGE and GAT with their graphs: phase 11b compares
# the packed runs' predictions with them
TRAINED: dict = {}
# phase 3's cached run's logits by node: phase 12a asks the router for
# the same nodes
PHASE3_LOGITS: dict = {}


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


def bound(bytes_: float, flops: float, peak: float = FP32_FLOPS_PER_S
          ) -> tuple:
    """The least time for the work: bytes over the memory rate or flops
    over ``peak`` (the card's rate for the inputs' type), the larger."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_case(torch, label, kernel, plain, args, *, timed=False,
               library=None, bytes_=0.0, flops=0.0, flush=None, rel=1e-4,
               elem_rel=None, elem_abs=None, peak=FP32_FLOPS_PER_S,
               gather_bytes=None):
    """Kernel vs plain on the same inputs: the max abs error within
    ``rel`` of the plain version's largest value, or, with ``elem_rel``,
    each element within ``elem_rel`` of its plain value plus its own
    ``elem_abs`` (a tensor of the output's shape) plus ``rel`` of the
    largest; optionally timed.  ``gather_bytes``, for a gather over a
    layout, are the bytes of every listed edge's row (not only the
    distinct ones) plus the output and the indices: over 3.35 TB/s they
    give ``gather_bound_ms``, the rate a scattered graph allows.  Returns
    the measurement dict and records a failure on disagreement."""
    out1 = kernel(*args)
    out2 = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    diff = (out1.float() - ref.float()).abs()
    err = diff.max().item() if ref.numel() else 0.0
    scale = ref.float().abs().max().item() if ref.numel() else 0.0
    excess_without_abs = None
    if elem_rel is not None and ref.numel():
        # how far the worst element lies outside its own bound
        over = diff - elem_rel * ref.float().abs()
        if elem_abs is not None:
            excess_without_abs = max(over.max().item(), 0.0)
            over = over - elem_abs
        err = max(over.max().item(), 0.0)
    bitwise = torch.equal(out1, out2)
    finite = bool(torch.isfinite(out1).all())
    ok = finite and bitwise and err <= rel * scale
    res = {"case": label, "shape": list(out1.shape),
           "max_abs_err": diff.max().item() if ref.numel() else 0.0,
           "max_abs_ref": scale, "bound_rel": rel,
           "bitwise_repeatable": bitwise, "ok": ok}
    if elem_rel is not None:
        res["bound_elem_rel"] = elem_rel
        res["max_excess"] = err
    if excess_without_abs is not None:
        res["max_excess_without_elem_abs"] = excess_without_abs
    if timed:
        res["ms"] = median_ms(torch, lambda: kernel(*args), flush)
        res["plain_ms"] = median_ms(torch, lambda: plain(*args), flush)
        res["library_ms"] = (median_ms(torch, library, flush)
                             if library is not None else None)
        res["bound_ms"], res["bound_by"] = bound(bytes_, flops, peak)
        if gather_bytes is not None:
            res["gather_bound_ms"] = gather_bytes / HBM_BYTES_PER_S * 1e3
    print("   " + json.dumps(res), flush=True)
    if not ok:
        failures.append(f"{label}: err {err} (max|ref| {scale}, "
                        f"elementwise {elem_rel}), "
                        f"bitwise {bitwise}, finite {finite}")
    return res


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def kernel_name(mangled: str) -> str:
    """``flash_fwd_wgmma_kernel[96]`` for a mangled kernel name: the
    last of its nested names (read length by length, so a name may hold
    digits, as ``flash_fwd_tf32_kernel`` does) and its integer template
    arguments."""
    i = 3 if mangled.startswith("_ZN") else 2 if mangled.startswith("_Z") \
        else 0
    name = None
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
    if not name or not name.endswith("_kernel"):
        return mangled
    args = re.findall(r"Li(\d+)E", mangled[i:]) if mangled[i:i + 1] == "I" \
        else []
    return name + (f"[{','.join(args)}]" if args else "")


def sass_counts(path, opcode: str) -> dict:
    """Instructions of SASS opcode ``opcode`` (any modifiers), per kernel
    of a built library (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            counts[fn] = 0
        elif fn and re.search(r"\b" + opcode + r"\b", line):
            counts[fn] += 1
    return counts


@phase("1. card and kernel build")
def phase_build(torch, results):
    from repro_torch.kernels import build
    print(f"   torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    out_dir, seconds, logs = build.build()
    print(f"   kernels built in {seconds:.1f} s -> {out_dir}")
    ptxas: dict = {}
    for name, log in logs.items():
        fn = name
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = kernel_name(m.group(1))
            elif ("registers" in line or "spill" in line
                  or "wgmma" in line.lower()):
                print(f"   ptxas {name} {fn}: {line.strip()}")
                ptxas.setdefault(fn, []).append(line.strip())
    # every K7 kernel (bf16 and float32, four head widths each) and K8's
    # bf16 kernels (N 64 and 128) run on the tensor cores: their SASS
    # holds HGMMA, and ptxas spills nothing in them
    hgmma = sass_counts(out_dir / "libflash_attention.so", "HGMMA")
    hgmma.update(sass_counts(out_dir / "libssd_chunk.so", "HGMMA"))
    print("   HGMMA instructions per K7 and K8 kernel (cuobjdump -sass): "
          + json.dumps(hgmma), flush=True)
    results["build"] = {"seconds": seconds, "ptxas": ptxas, "hgmma": hgmma}
    tc = {k: n for k, n in hgmma.items()
          if k.startswith(("flash_fwd", "ssd_state_wgmma"))}
    require(len(tc) == 10 and all(tc.values()),
            f"HGMMA in each of the eight K7 kernels and K8's two bf16 "
            f"kernels: {tc}")
    spills = {k: v for k, v in ptxas.items() if k in tc and any(
        re.search(r"[1-9]\d* bytes spill", line) for line in v)}
    require(not spills, f"no ptxas spills in the tensor-core kernels: "
            f"{spills}")
    # each launch_plan states the shared memory its kernel asks for
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_chunk as sc
    smem = {}
    for hd in fa.HEAD_DIMS:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.zeros(1, 1, 64, hd, dtype=dtype)
            smem[f"flash_attention[{hd}, {dtype}]"] = (
                fa.launch_plan(q, q, q, q)["smem_bytes"],
                build.library("flash_attention").flash_attention_smem(
                    hd, int(dtype == torch.bfloat16)))
    for N in sc.TC_NS:
        x = torch.zeros(1, 256, 1, sc.TC_P, dtype=torch.bfloat16)
        Bm = torch.zeros(1, 256, 1, N, dtype=torch.bfloat16)
        smem[f"ssd_chunk_state[{N}]"] = (
            sc.launch_plan(x, Bm)["smem_bytes"],
            build.library("ssd_chunk").ssd_chunk_state_smem(N))
    results["build"]["smem_plan_vs_library"] = smem
    require(all(a == b for a, b in smem.values()),
            f"launch_plan's shared memory is the kernel's: {smem}")


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
           transpose=False, timed=True, col=None):
        """K1 ``out[d] = sum coef_e h[idx_e]`` over a grouped layout; over
        the src layout (gathering through ``edge_dst``) it is the
        transpose.  ``coef`` (E,) or (E, heads).  With a column ``col``
        of ``coef``'s shape, the launch also sums it per head (the GAT
        VJP's source pass): its sum is checked apart, and the timed launch
        makes both."""
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
        plain = ss.gather_scale_segment_sum_plain
        args = (h, idx, coef, order, row_ptr, num_out)
        col_bytes = 0
        if col is not None:
            col_bytes = 4 * heads * (nnz + num_out)
            check_case(torch, label + ", its column sum",
                       lambda *a: kernel(*a, col=col)[1],
                       lambda *a: plain(*a, col=col)[1], args)
            kernel = functools.partial(kernel, col=col)
            plain = functools.partial(plain, col=col)
            kernel_out = lambda *a: kernel(*a)[0]
            plain_out = lambda *a: plain(*a)[0]
        else:
            kernel_out, plain_out = kernel, plain
        idx_bytes = (8 + 4 * heads) * nnz + col_bytes
        return check_case(
            torch, label, kernel_out, plain_out, args, timed=timed,
            library=library,
            bytes_=4 * (U * F + num_out * F) + idx_bytes, flops=2 * nnz * F,
            flush=self.flush,
            gather_bytes=4 * (nnz * F + num_out * F) + idx_bytes)

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
            flops=nnz * heads * (8 + 2 * hd), flush=self.flush,
            gather_bytes=(4 * (nnz * heads * hd + D * heads * hd
                               + nnz * heads + D * heads) + 12 * nnz))

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
    PHASE3_LOGITS.update({r.node_id: r.logits for r in res["responses"]})
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


def dev_us(e) -> float:
    """Self device time of a profiler row, in microseconds."""
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profile_active_step(torch, step):
    """``torch.profiler`` over ``step`` as the active step of a profile
    that first records one warm-up step (a profile that starts right
    before the step loses its first device work); the profile runs twice,
    since the first pays CUPTI's start-up."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for _ in range(2):
                step()
                torch.cuda.synchronize()
                prof.step()
    return prof


def device_rows(prof) -> list:
    """Device-side rows of a profile, largest first: CPU ops carry their
    children's device time too, and GPU ranges of user annotations overlap
    the kernels inside them."""
    from torch.autograd import DeviceType
    rows = [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and dev_us(e) > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("Optimizer.")]
    return sorted(rows, key=dev_us, reverse=True)


@phase("3c. where one serving forward spends device time")
def phase_profile(torch, blocks, x_np, results):
    """One bucket-64 forward as ``serve_batch`` runs it (host arrays to
    the card, forward, logits back): its wall time, the host-to-card copy
    of the input rows alone, and under ``torch.profiler`` (as the active
    step after a profiled warm-up step) the device time by kernel and the
    kernels' share of the step."""
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
    # device-side kernels only (the profiler stretches pageable copies,
    # timed by the host clock above instead), profiled as the active step
    # after a profiled warm-up step: a profile that starts right before
    # the step loses its first device work
    prof = profile_active_step(torch, step)
    rows = [e for e in device_rows(prof)
            if not e.key.startswith(("Memcpy", "Memset"))]
    kernels_ms = sum(dev_us(e) for e in rows) / 1e3
    print(f"   step wall {wall_ms:.3f} ms (median of 5); input rows "
          f"{x_np.nbytes / 2**20:.1f} MiB host -> card {copy_ms:.3f} ms "
          f"({x_np.nbytes / copy_ms / 1e6:.1f} GB/s); kernels "
          f"{kernels_ms:.3f} ms of device time ({kernels_ms / wall_ms:.2%} "
          f"of the step), {sum(e.count for e in rows)} kernel launches",
          flush=True)
    for e in rows[:8]:
        print(f"   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<3d} {e.key[:90]}")
    results["profile.serve"] = {
        "wall_ms": wall_ms, "copy_ms": copy_ms, "kernels_ms": kernels_ms,
        "kernels": [{"kernel": e.key, "count": e.count,
                     "ms": dev_us(e) / 1e3} for e in rows]}


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
    """The GAT backward (its destination pass, then K1 over the src
    layout with an (E, heads) coefficient and column) from the forward's
    saved ``(m, l)``, against autograd through the plain forward; timed,
    its plain version is that autograd backward."""
    from repro_torch.kernels import gat_fused as gf
    N, E, nnz = dg.num_src, dg.edge_src.numel(), int(dg.order.numel())
    src, dst, order, row_ptr = dg.edge_src, dg.edge_dst, dg.order, dg.row_ptr
    F = heads * hd
    hs, es, ed, gout = (c.randn(N, F), c.randn(N, heads), c.randn(N, heads),
                        c.randn(N, F))
    _, m, l = gf.gat_attention_cuda(hs, es, ed, src, order, row_ptr, N,
                                    stats=True)
    bwd_args = (gout, hs, es, ed, m, l, src, dst, order, row_ptr,
                dg.src_layout)
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
            4 * (3 * N * F + 6 * N * heads) + 8 * E + 8 * nnz + 8 * (N + 1),
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
    # the GAT VJP's source pass: alpha as the coefficient, dpre as the
    # column summed beside; and K1 alone at those shapes
    emask = dga.edge_mask[:, None].to(torch.float32)
    alpha = torch.rand((Ea, GAT_HEADS), generator=c.gen).to(dev) * emask
    dpre = randn(Ea, GAT_HEADS) * emask
    for F in (HIDDEN, GAT_CLASSES):
        w = f"4x{F // GAT_HEADS}"
        g_rows = randn(N, F)
        results[f"k1_transpose.{w}"] = c.k1(
            f"K1 over the src layout, 4 heads x {F // GAT_HEADS}", g_rows,
            dga.edge_dst, alpha, *dga.src_layout, N, transpose=True)
        results[f"k1_transpose_col.{w}"] = c.k1(
            f"K1 over the src layout, 4 heads x {F // GAT_HEADS}, with a "
            f"column", g_rows, dga.edge_dst, alpha, *dga.src_layout, N,
            transpose=True, col=dpre)
    # K2: GIN's layer-0 and layer-1 sums, the Scatter's transpose (src
    # layout)
    for F in (FEAT, HIDDEN):
        results[f"segment_sum.full.{F}"] = c.k2(
            f"K2 full graph, GIN ({E} x {F} -> {N})",
            randn(E, F) * mask[:, None], dst, order, row_ptr, N)
    results["segment_sum.src.256"] = c.k2(
        f"K2 over the src layout ({E} x {HIDDEN} -> {N})",
        randn(E, HIDDEN) * mask[:, None], src, order_s, row_ptr_s, N)
    # K5: GIN's layer-0 Scatter (602 wide: float2 loads) through
    # edge_src, walking the src layout as GatherRows does; its layer-1
    # Scatter of the destinations and K2's backward (256 wide: float4
    # loads) over the dst layout
    results["gather_rows.602"] = c.k5(
        f"K5 gather ({E} x {FEAT}, src layout)", randn(N, FEAT), src,
        order_s, E)
    # the same gather walking the dst layout, as GatherRows did before it
    # took the layout grouped by its index: rows read out of turn
    results["gather_rows.602.dst"] = c.k5(
        f"K5 gather ({E} x {FEAT}, dst layout)", randn(N, FEAT), src,
        order, E)
    results["gather_rows"] = c.k5(
        f"K5 gather ({E} x {HIDDEN})", randn(N, HIDDEN), dst, order, E)
    # K3 over the whole graph at GAT's two layers
    for heads, hd in ((GAT_HEADS, HIDDEN // GAT_HEADS),
                      (GAT_HEADS, GAT_CLASSES // GAT_HEADS)):
        results[f"gat_attention.full.{heads}x{hd}"] = c.k3(
            f"K3 GAT's full graph, {heads} x {hd}", dga, heads, hd)
    # K6: the reference's single-head edge dot (K1's dcoef), and per head
    # at GAT's two widths (its multi-head path, which no trainer launches)
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
    # the row of the kernels line: the single-head dcoef (no trainer
    # launches K6; GAT's VJP takes its dalpha in its own pass)
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
        flops=4 * bnnz * FEAT, flush=flush,
        gather_bytes=bnnz * FEAT + 8 * bnnz + 4 * blk.num_dst * FEAT
        + 12 * bnnz)

    # the GAT backward at both layers' shapes, each timed
    results["gat_backward"], (hs, es, ed, gout) = gat_backward_case(
        torch, c, dga, GAT_HEADS, HIDDEN // GAT_HEADS, timed=True)
    results[f"gat_backward.{GAT_HEADS}x{GAT_CLASSES // GAT_HEADS}"], _ = \
        gat_backward_case(torch, c, dga, GAT_HEADS,
                          GAT_CLASSES // GAT_HEADS, timed=True)

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
                    a, b, c, dga.edge_src, dga.edge_dst, dga.order,
                    dga.row_ptr, dga.src_layout, N),
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
        if arch in ("gcn", "sage", "gat"):
            TRAINED[arch] = (res["model"], res["graph"])   # phases 11b, 14
        if arch in ("gcn", "gat"):
            _profile_step(torch, arch, classes, res["graph"], results)


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


# the port's kernels by name, as the profiler lists them
PORT_KERNELS = ("gss_lanes_kernel", "segmented_rows", "gather_rows_kernel",
                "edge_dot_kernel", "gat_forward_kernel",
                "gat_backward_dst_kernel")


def _profile_step(torch, arch, classes, g, results):
    """One full-batch training step of ``arch`` under ``torch.profiler``:
    device time split into the port's kernels (each kernel by name: a
    template's instances, such as one kernel at two widths, are listed
    apart), matrix products, copies and the rest (elementwise, the
    optimizer).  The step is profiled twice: alone in a profiling
    session, and as the active step of a session that first profiles one
    warm-up step (``torch.profiler.schedule``): alone, the session misses
    the step's first device work.  For GCN, beside it, CUDA-event times of
    the step's two 602-wide products (the forward ``x @ w`` and the
    weight gradient ``x^T @ dh``), each 72 GFLOP."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.models.gnn import model as GM
    from repro_torch.optim import AdamW
    dev = torch.device("cuda")
    cfg = GM.GNNConfig(arch=arch, feat_dim=FEAT, hidden=HIDDEN,
                       num_classes=classes)
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

    def kind(key):
        k = key.lower()
        if any(n in k for n in PORT_KERNELS):
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
        print(f"   {arch} step profiled {label}: wall {wall_ms:.3f} ms, "
              f"device {total:.3f} ms ({total / wall_ms:.2%} busy), "
              f"{sum(e.count for e in rows)} device events; split (ms): "
              + json.dumps(split), flush=True)
        # every port kernel, then the largest of the rest
        shown = [r for r in listing if r["kind"] == "port kernels"]
        shown += [r for r in listing if r["kind"] != "port kernels"][:10]
        for r in shown:
            print(f"   {r['ms']:9.3f} ms  x{r['count']:<3d} {r['kind']:15s} "
                  f"{r['kernel'][:80]}")
        profiles[label] = {"device_ms": total, "split_ms": split,
                           "kernels": listing}
    results[f"profile.{arch}"] = {"wall_ms": wall_ms, "profiles": profiles}
    if arch != "gcn":
        return
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
    results["profile.gcn"].update(x_w_ms=fwd_ms, xT_dh_ms=wgrad_ms,
                                  gflop_each=gflop)


@phase("7. mini-batch GraphSAGE at Reddit widths, fp32 and int8")
def phase_minibatch(torch, results):
    from repro_torch.kernels import ops
    from repro_torch.launch import train_gnn
    for codec in ("fp32", "int8"):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        # the int8 run takes MB_INT8_STEPS steps of its epoch
        res = train_gnn.run(train_gnn.parse_args(train_args(
            "sage", CLASSES, [
                "--minibatch", "--batch", str(MB_BATCH), "--epochs", "1",
                "--cache", "degree", "--wire-codec", codec,
                *(["--use-kernel"] if codec == "int8" else [])])),
            steps_per_epoch=MB_INT8_STEPS if codec == "int8" else 0)
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


# ---------------------------------------------------------------------------
# phase 11: locality reordering, the dataset registry, the importance and
# layer-wise samplers and serving a changing graph, at Reddit's widths
# ---------------------------------------------------------------------------

REORDER_POLICIES = ("none", "degree", "bfs", "rcm")
# the phase-5 cases phase 11(a) repeats over each packed graph, under
# phase 5's keys
REORDER_CASES = ("k1.full.602", f"k1.full.{HIDDEN}", f"k1.full.{CLASSES}",
                 f"k1_transpose.{HIDDEN}",
                 f"gat_attention.full.{GAT_HEADS}x{HIDDEN // GAT_HEADS}",
                 "gat_backward", "gather_rows.602")
# the events of phase 11(d)'s stream (half feature rows, the rest edge
# additions and removals)
UPDATE_EVENTS = 2000
# ImportanceSampler walks 8 x 2 steps in Python per destination (about
# 0.9-2.8 s a batch of 1024 on a CPU core): phase 11(e) runs it one epoch
# over a sixteenth of the nodes, at the same widths and degree
IMPORTANCE_NODES = NODES // 16


def packed(g):
    """Each policy's packing of ``g``, with the host seconds it took and
    its ``locality_report``."""
    from repro_torch.core.reordering import locality_report, reorder_graph
    for policy in REORDER_POLICIES:
        t0 = time.perf_counter()
        gp, _, _ = reorder_graph(g, policy)
        secs = time.perf_counter() - t0
        yield policy, gp, {"seconds": secs, **locality_report(gp)}


def reorder_cases(torch, c, g, g_gat) -> dict:
    """Phase 5's whole-graph cases of the gathers over ``g`` (41 classes)
    and ``g_gat`` (40), as packed: K1 at 602 (SAGE layer 0), 256 and 41,
    K1ᵀ at 256, K3 and its VJP at 4 x 64, K5 at 602 over the src layout.
    K5's and the VJP's results gain a ``gather_bound_ms``: every listed
    edge's row (the VJP: hs in its destination pass, g in its source
    pass), the outputs and the indices over 3.35 TB/s."""
    from repro_torch.core.abstraction import DeviceGraph
    dev, randn = c.dev, c.randn
    dg = DeviceGraph.from_graph(g, dev, src_layout=True)
    N, E = g.num_nodes, dg.edge_src.numel()
    src, dst, order, row_ptr = dg.edge_src, dg.edge_dst, dg.order, dg.row_ptr
    order_s, row_ptr_s = dg.src_layout
    nnz = int(order.numel())
    coef = torch.rsqrt(dg.out_deg)[src.long()] * \
        torch.rsqrt(dg.in_deg)[dst.long()]
    out = {"k1.full.602": c.k1(
        f"K1 full graph, SAGE layer 0 (F {FEAT})", randn(N, FEAT), src,
        dg.edge_mask.to(torch.float32), order, row_ptr, N)}
    for F in (HIDDEN, CLASSES):
        out[f"k1.full.{F}"] = c.k1(f"K1 full graph, F {F}", randn(N, F), src,
                                   coef, order, row_ptr, N)
    out[f"k1_transpose.{HIDDEN}"] = c.k1(
        f"K1 over the src layout, GCN F={HIDDEN}", randn(N, HIDDEN), dst,
        coef, order_s, row_ptr_s, N, transpose=True)
    r = c.k5(f"K5 gather ({E} x {FEAT}, src layout)", randn(N, FEAT), src,
             order_s, E)
    r["gather_bound_ms"] = (4 * 2 * nnz * FEAT + 8 * nnz) / HBM_BYTES_PER_S \
        * 1e3
    out["gather_rows.602"] = r
    dga = DeviceGraph.from_graph(g_gat, dev, src_layout=True)
    hd = HIDDEN // GAT_HEADS
    out[f"gat_attention.full.{GAT_HEADS}x{hd}"] = c.k3(
        f"K3 GAT's full graph, 4 x {hd}", dga, GAT_HEADS, hd)
    r, _ = gat_backward_case(torch, c, dga, GAT_HEADS, hd, timed=True)
    na, Ea, Na = int(dga.order.numel()), dga.edge_src.numel(), dga.num_src
    r["gather_bound_ms"] = (4 * (2 * na * HIDDEN + 2 * Na * HIDDEN
                                 + 6 * Na * GAT_HEADS) + 16 * na + 8 * Ea) \
        / HBM_BYTES_PER_S * 1e3
    out["gat_backward"] = r
    return out


@phase("11a. the gathers over the graph as each reorder policy packs it")
def phase_reorder_kernels(torch, g, g_gat, results):
    """For each policy, ``g`` (41 classes) and ``g_gat`` (40) packed
    by ``reorder_graph`` (its host seconds and ``locality_report``
    printed), then :func:`reorder_cases` on them, each case held against
    its plain version within phase 5's bounds and timed as there (25
    launches, L2 flushed), beside phase 5's time of the unpacked graph
    from this process."""
    out = {}
    for (policy, gp, rep), (_, gap, rep_gat) in zip(packed(g),
                                                    packed(g_gat)):
        print(f"   reorder={policy}: {rep['seconds']:.2f} s (GAT's graph "
              f"{rep_gat['seconds']:.2f} s); " + json.dumps(rep), flush=True)
        cases = reorder_cases(torch, Checker(torch, seed=5), gp, gap)
        line = []
        for key in REORDER_CASES:
            r, base = cases[key], results.get(key, {}).get("ms")
            share = r["gather_bound_ms"] / r["ms"]
            line.append(f"{key} {r['ms']:.5g} ms ["
                        + ("not run" if base is None else f"{base:.5g}")
                        + f"] {share:.0%} of gather bound")
        print(f"   {policy}: " + "; ".join(line), flush=True)
        out[policy] = {"locality": rep, "locality_gat": rep_gat,
                       "cases": cases}
    results["reorder.kernels"] = out


def final_logits(torch, arch, classes, model, g):
    """``model``'s logits over all of ``g`` on the card, on the host."""
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.models.gnn import model as GM
    cfg = GM.GNNConfig(arch=arch, feat_dim=FEAT, hidden=HIDDEN,
                       num_classes=classes)
    dev = torch.device("cuda")
    with torch.no_grad():
        return GM.forward_full(cfg, model, DeviceGraph.from_graph(g, dev),
                               torch.from_numpy(g.features).to(dev)
                               ).cpu().numpy()


@phase("11b. full-batch SAGE and GAT over the packed graph")
def phase_reorder_train(torch, results):
    """SAGE and GAT full-batch through ``train_gnn --reorder bfs`` and
    ``rcm``: launches as phase 6's and each epoch's loss within 1e-4
    (relative) of phase 6's unpacked run of the same arch (training is
    invariant under the relabelling up to summation order).  The trained
    models' predictions, mapped back to the original ids, agree with phase
    6's model's except on near ties: a node whose class differs has a top-2
    margin in phase 6's logits within 1e-3 of their largest value (float32
    sums in another order, amplified by ten AdamW epochs, can flip those).
    The accuracy difference is printed in nodes."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train_gnn
    for arch in ("sage", "gat"):
        classes = GAT_CLASSES if arch == "gat" else CLASSES
        base = results[f"train.{arch}"]
        logits0 = final_logits(torch, arch, classes, *TRAINED[arch])
        pred0 = logits0.argmax(1)
        top2 = np.sort(logits0, 1)[:, -2:]
        margin0 = top2[:, 1] - top2[:, 0]
        for policy in ("bfs", "rcm"):
            ops.reset_launch_counts()
            res = train_gnn.main(train_args(arch, classes, [
                "--epochs", str(TRAIN_EPOCHS), "--reorder", policy]))
            torch.cuda.synchronize()
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            rel = max(abs(a - b) / abs(b)
                      for a, b in zip(res["losses"], base["losses"]))
            logits = final_logits(torch, arch, classes, res["model"],
                                  res["graph"])[res["reorder"]["inv"]]
            flipped = logits.argmax(1) != pred0
            near = 1e-3 * float(np.abs(logits0).max())
            summary = {
                "losses": res["losses"], "max_rel_loss_diff": rel,
                "accuracy": res["accuracy"],
                "accuracy_diff_nodes": round(abs(res["accuracy"]
                                                 - base["accuracy"]) * NODES),
                "max_abs_logit_diff": float(np.abs(logits - logits0).max()),
                "predictions_differing": int(flipped.sum()),
                "their_max_margin": float(margin0[flipped].max())
                if flipped.any() else 0.0, "near_tie_bound": near,
                "median_epoch_ms": float(np.median(res["epoch_s"][1:]))
                * 1e3, "unpacked_median_epoch_ms": base["median_epoch_ms"],
                "reorder_s": res["reorder"]["seconds"], "launches": counts}
            print(f"   {arch} --reorder {policy}: " + json.dumps(summary),
                  flush=True)
            results[f"reorder.train.{arch}.{policy}"] = summary
            want = _expected(arch, TRAIN_EPOCHS)
            require(counts == want, f"{arch} {policy}: launches {counts}, "
                    f"by design {want}")
            require(len(res["losses"]) == len(base["losses"])
                    and rel <= 1e-4, f"{arch} {policy}: losses within 1e-4 "
                    f"of the unpacked run ({rel})")
            require(summary["their_max_margin"] <= near,
                    f"{arch} {policy}: predictions that differ from the "
                    f"unpacked run's are near ties ({summary})")


def serve_args(extra=()):
    return ["--arch", "sage", "--nodes", str(NODES), "--classes",
            str(CLASSES), "--feat-dim", str(FEAT), "--hidden", str(HIDDEN),
            "--fanouts", *map(str, FANOUTS), "--device", "cuda", *extra]


@phase("11c. serve GraphSAGE over the bfs-packed graph")
def phase_reorder_serve(torch, results):
    """``serve_gnn --reorder bfs --requests 128``: every request answered
    in the workload's original ids, in its order, K1 twice a forward;
    p50 and req/s beside phase 3's unpacked run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_gnn
    from repro_torch.serving import poisson_workload
    ops.reset_launch_counts()
    res = serve_gnn.main(serve_args(["--requests", "128", "--reorder",
                                     "bfs"]))
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    base = res["no_cache"]
    forwards = res["forward_calls"] + base["forward_calls"]
    # the launcher's workload, as its clients sent it
    sent = [r.node_id for r in poisson_workload(128, np.arange(NODES),
                                                2000.0, seed=1)]
    summary = {k: res[k] for k in ("served", "throughput_rps", "p50_ms",
                                   "p99_ms", "embedding_hit_ratio")}
    summary.update(no_cache={k: base[k] for k in (
        "served", "throughput_rps", "p50_ms", "p99_ms")},
        reorder_s=res["reorder"]["seconds"] if "reorder" in res else None,
        launches=counts, forward_calls=forwards,
        unpacked=results.get("serve", "not run"))
    print("   serve --reorder bfs: " + json.dumps(summary, default=str),
          flush=True)
    print("   (SAGE serving is host-bound: PERF.md §7 records 1 599 to "
          "1 999 req/s for unchanged code on different machines)")
    results["reorder.serve"] = summary
    for name, r in (("cached", res), ("no-cache", base)):
        require(r["served"] == 128 and r["all_logits_finite"],
                f"{name}: every request answered, finite logits")
        require([q.node_id for q in r["responses"]] == sent,
                f"{name}: responses in the workload's original ids")
    require(counts == {"gather_scale_segment_sum": 2 * forwards},
            f"K1 twice a forward: {counts}, {forwards} forwards")


@phase("11d. serve GraphSAGE over a changing graph")
def phase_update_stream(torch, g, results):
    """A stream of :data:`UPDATE_EVENTS` events from ``synthesize_updates``
    on ``g`` (the 41-class graph), written to ``chiprun_out/``, served by
    ``serve_gnn --update-stream`` (128 requests, staleness 4, so cached
    rows outside a fold's frontier stay servable): its folds, events,
    touched nodes and invalidated rows; then a cold server built on
    ``log.apply(g)`` with the same weights answers a fixed set of seeds
    (the touched nodes first) as the updated server does, within 1e-5."""
    from repro_torch.core.updates import load_update_stream, synthesize_updates
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_gnn
    from repro_torch.serving import GNNInferenceServer
    from repro_torch.serving.batcher import MicroBatch
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out", "updates.jsonl")
    n_events = synthesize_updates(g, UPDATE_EVENTS, seed=11).to_jsonl(path)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve_gnn.main(serve_args(["--requests", "128", "--staleness", "4",
                                     "--update-stream", path]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    forwards = res["forward_calls"] + res["no_cache"]["forward_calls"]
    folds = res["folds"]
    summary = {"events_in_stream": n_events, "folds": len(folds),
               "events": sum(f["events"] for f in folds),
               "touched_nodes": sum(f["touched_nodes"] for f in folds),
               "invalidated_rows": sum(f["invalidated_rows"] for f in folds),
               "update_seq": res["update_seq"],
               "no_cache_update_seq": res["no_cache"]["update_seq"],
               "served": res["served"], "throughput_rps":
               res["throughput_rps"], "p50_ms": res["p50_ms"],
               "p99_ms": res["p99_ms"], "launches": counts, "wall_s": wall}
    print("   serve --update-stream: " + json.dumps(summary), flush=True)
    require(res["served"] == 128 and res["no_cache"]["served"] == 128
            and res["all_logits_finite"], "every request answered, finite")
    require(res["update_seq"] == n_events
            and res["no_cache"]["update_seq"] == n_events
            and summary["events"] == n_events, "every event folded")
    require(counts == {"gather_scale_segment_sum": 2 * forwards},
            f"K1 twice a forward: {counts}, {forwards} forwards")

    srv = res["server"]
    log = load_update_stream(path)
    t0 = time.perf_counter()
    cold = GNNInferenceServer(
        log.apply(g), srv.cfg, srv.params, fanouts=list(FANOUTS),
        buckets=srv.batcher.buckets, cache_policy="degree",
        cache_capacity=int(NODES * 0.2), max_staleness=4, seed=0)
    cold.warmup()
    cold_s = time.perf_counter() - t0
    touched = log.delta(0).nodes
    rng = np.random.default_rng(12)
    others = np.setdiff1d(rng.choice(NODES, 256, replace=False), touched)
    seeds = np.concatenate([touched[:128], others[:128]])
    worst, top = 0.0, 0.0
    for start in range(0, len(seeds), BUCKET):
        ids = np.full(BUCKET, -1, np.int64)
        chunk = seeds[start:start + BUCKET]
        ids[:len(chunk)] = chunk
        a = srv.serve_batch(MicroBatch([], ids, BUCKET, 0.0))[:len(chunk)]
        b = cold.serve_batch(MicroBatch([], ids, BUCKET, 0.0))[:len(chunk)]
        worst = max(worst, float(np.abs(a - b).max()))
        top = max(top, float(np.abs(b).max()))
    summary.update(delta_vs_cold_max_abs=worst, cold_max_abs=top,
                   cold_build_s=cold_s, seeds=len(seeds))
    print(f"   updated server vs a cold one on log.apply(g), {len(seeds)} "
          f"seeds ({min(128, len(touched))} touched): max |diff| "
          f"{worst:.3e} (max |logit| {top:.3e}); cold build "
          f"{cold_s:.1f} s", flush=True)
    results["update_stream"] = summary
    require(worst <= 1e-5, f"updated server within 1e-5 of a cold rebuild "
            f"({worst})")


def timed_k1_host(torch):
    """Wrap K1's CUDA wrapper to keep each call's host seconds; returns
    the list and a function that restores the wrapper."""
    from repro_torch.kernels import segment_sum as ss
    saved, host = ss.gather_scale_segment_sum_cuda, []

    def call(*args, **kw):
        t0 = time.perf_counter()
        out = saved(*args, **kw)
        host.append(time.perf_counter() - t0)
        return out
    ss.gather_scale_segment_sum_cuda = call

    def restore():
        ss.gather_scale_segment_sum_cuda = saved
    return host, restore


@phase("11e. mini-batch GraphSAGE with the new samplers")
def phase_samplers(torch, results):
    """``train_gnn --minibatch --sampler importance|fastgcn|ladies``, SAGE
    602 → 256 → 41, batch 1024, one epoch (importance over
    :data:`IMPORTANCE_NODES` nodes): finite, falling loss and K1's
    launches as phase 7's fp32 run (two forward, one transpose a step).
    The layer-wise blocks change E every step; K1's plan search is
    memoised per shape and not per E, so its searches during a run stay
    as few as the shapes, and each launch's host time is that of a launch
    (both read here)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.launch import train_gnn
    for sampler in ("importance", "fastgcn", "ladies"):
        nodes = IMPORTANCE_NODES if sampler == "importance" else NODES
        ops.reset_launch_counts()
        searches = ss._gss_plan.cache_info().misses
        host, restore = timed_k1_host(torch)
        t0 = time.perf_counter()
        try:
            args = train_args("sage", CLASSES, [
                "--minibatch", "--sampler", sampler, "--batch",
                str(MB_BATCH), "--epochs", "1", "--cache", "degree"])
            args[args.index("--nodes") + 1] = str(nodes)
            res = train_gnn.main(args)
        finally:
            restore()
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        losses, steps = res["losses"], res["steps"]
        summary = {"nodes": nodes, "steps": steps,
                   "wall_s": time.perf_counter() - t0,
                   "median_step_ms": float(np.median(res["step_s"])) * 1e3,
                   "loss_first10": float(np.mean(losses[:10])),
                   "loss_last10": float(np.mean(losses[-10:])),
                   "launches": counts,
                   "k1_plan_searches": ss._gss_plan.cache_info().misses
                   - searches,
                   "k1_host_us_median": float(np.median(host)) * 1e6,
                   "k1_host_us_max_after_first_10":
                   float(np.max(host[10:])) * 1e6 if len(host) > 10
                   else None}
        print(f"   minibatch sage --sampler {sampler}: "
              + json.dumps(summary), flush=True)
        results[f"sampler.{sampler}"] = summary
        require(bool(np.isfinite(losses).all())
                and summary["loss_last10"] < summary["loss_first10"],
                f"{sampler}: finite, falling loss")
        want = {"gather_scale_segment_sum": 2 * steps,
                "gather_scale_segment_sum_t": steps}
        require(counts == want, f"{sampler}: launches {counts}, by design "
                f"{want}")
        require(summary["k1_plan_searches"] <= 4,
                f"{sampler}: {summary['k1_plan_searches']} K1 plan searches "
                f"in {steps} steps")


@phase("11f. each launcher over a named dataset")
def phase_datasets(torch, results):
    """``train_gnn --dataset pubmed-like`` (GCN full-batch, 10 epochs) and
    ``serve_gnn --dataset reddit-like`` (SAGE, 64 requests): a path
    check, launches as designed."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_gnn, train_gnn
    ops.reset_launch_counts()
    res = train_gnn.main(["--arch", "gcn", "--dataset", "pubmed-like",
                          "--hidden", str(HIDDEN), "--epochs",
                          str(TRAIN_EPOCHS), "--device", "cuda"])
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    losses = res["losses"]
    summary = {"train": {"losses": losses, "accuracy": res["accuracy"],
                         "median_epoch_ms": float(np.median(
                             res["epoch_s"][1:])) * 1e3,
                         "launches": counts}}
    require(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
            f"pubmed-like: finite, falling loss {losses}")
    want = _expected("gcn", TRAIN_EPOCHS)
    require(counts == want, f"pubmed-like: launches {counts}, by design "
            f"{want}")
    ops.reset_launch_counts()
    res = serve_gnn.main(["--arch", "sage", "--dataset", "reddit-like",
                          "--hidden", str(HIDDEN), "--requests", "64",
                          "--device", "cuda"])
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    forwards = res["forward_calls"] + res["no_cache"]["forward_calls"]
    summary["serve"] = {k: res[k] for k in ("served", "throughput_rps",
                                            "p50_ms", "p99_ms")}
    summary["serve"]["launches"] = counts
    print("   datasets: " + json.dumps(summary), flush=True)
    results["datasets"] = summary
    require(res["served"] == 64 and res["all_logits_finite"],
            "reddit-like: every request answered, finite logits")
    require(counts == {"gather_scale_segment_sum": 2 * forwards},
            f"reddit-like: K1 twice a forward: {counts}")


# ---------------------------------------------------------------------------
# replicated serving: phase 3's SAGE behind the router
# ---------------------------------------------------------------------------

def router_run(torch, label, extra):
    """``serve_gnn`` in replicated mode on phase 3's graph and model (the
    launch counts set to 0 just before): every request answered once,
    finite, zero drops and zero torn batches; req/s, p50 and p99 printed
    as the virtual-clock numbers they are.  Returns the launcher's
    result and a JSON-able summary."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_gnn
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = serve_gnn.main(serve_args(extra))
    torch.cuda.synchronize()
    n = int(extra[extra.index("--requests") + 1])
    summary = {k: res[k] for k in (
        "served", "dropped", "torn_batches", "throughput_rps", "p50_ms",
        "p99_ms", "replicas_peak", "replicas_final", "hot_swaps",
        "version_counts", "scale_events", "params_version",
        "forward_calls")}
    # the router's req/s divides by the host's wall time of its run, in
    # which the replicas computed one after another on this card; on the
    # virtual clock, where N replicas model N cards, the run spans first
    # arrival to last answer
    span = (max(r.done_s for r in res["responses"])
            - min(r.arrival_s for r in res["responses"]))
    summary.update(virtual_rps=n / span,
                   embedding_hit_ratio=res.get("embedding_hit_ratio"),
                   wall_s=time.perf_counter() - t0)
    print(f"   {label}: virtual clock (N replicas model N cards): "
          f"{summary['virtual_rps']:.1f} req/s, p50 {summary['p50_ms']:.3f} "
          f"ms, p99 {summary['p99_ms']:.3f} ms; wall (the replicas in turn "
          f"on this card): {summary['throughput_rps']:.1f} req/s "
          + json.dumps(summary), flush=True)
    require(res["served"] == n and res["dropped"] == 0
            and sum(res["version_counts"].values()) == n,
            f"{label}: every request served once, none dropped")
    require(res["torn_batches"] == 0, f"{label}: no torn batch")
    require(res["all_logits_finite"], f"{label}: finite logits")
    return res, summary


def require_k1_per_forward(torch, label, forwards):
    """K1 launched exactly twice per forward since the last reset, and no
    other kernel."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    require(counts == {"gather_scale_segment_sum": 2 * forwards},
            f"{label}: K1 twice a forward: {counts}, {forwards} forwards")
    return counts


@phase("12a. replicated SAGE serving: 2 replicas, both dispatch policies")
def phase_replicas(torch, results):
    """``--replicas 2`` under ``least_queue`` and ``round_robin``, 256
    requests at 2 000 req/s; then 32 of the nodes phase 3 served, asked of
    the same router (version 0): within 1e-5 of phase 3's largest logit.
    K1 twice a forward across the fleet, warmups included."""
    from repro_torch.serving import InferenceRequest
    nodes = sorted(PHASE3_LOGITS)[:32]
    require(len(nodes) == 32, f"phase 3 served 32 nodes ({len(nodes)})")
    for policy in ("least_queue", "round_robin"):
        label = f"--replicas 2 --router-policy {policy}"
        res, summary = router_run(torch, label, [
            "--requests", "256", "--replicas", "2", "--router-policy",
            policy])
        router = res["router"]
        wl = [InferenceRequest(i, n, 0.0) for i, n in enumerate(nodes)]
        router.run(wl)
        worst = max(float(np.abs(r.logits - PHASE3_LOGITS[r.node_id]).max())
                    for r in wl)
        top = max(float(np.abs(PHASE3_LOGITS[n]).max()) for n in nodes)
        summary.update(
            dispatched={r.rid: r.served for r in router.replicas},
            vs_phase3_max_abs=worst, phase3_max_abs=top,
            launches=require_k1_per_forward(torch, label,
                                            router.forward_calls))
        print(f"   32 of phase 3's nodes through the router at version "
              f"{router.version}: max |diff| {worst:.3e} (max |logit| "
              f"{top:.3e})", flush=True)
        results[f"replicas.{policy}"] = summary
        require(all(r.params_version == 0 for r in wl),
                "answered at version 0")
        require(worst <= 1e-5 * top, f"{label}: within 1e-5 of phase 3's "
                f"largest logit ({worst})")


@phase("12b. replicated SAGE serving: autoscaling from one replica")
def phase_autoscale(torch, results):
    res, summary = router_run(torch, "--replicas 1 --autoscale", [
        "--requests", "512", "--replicas", "1", "--autoscale", "--rate",
        "8000"])
    stats = res["router"].stats
    summary.update(scale_actions=[e["action"] for e in stats.scale_events],
                   launches=require_k1_per_forward(
                       torch, "autoscale", res["router"].forward_calls))
    print(f"   replicas: peak {stats.replicas_peak}, final "
          f"{stats.replicas_final}; actions {summary['scale_actions']}",
          flush=True)
    results["replicas.autoscale"] = summary
    require("up" in summary["scale_actions"], "at least one scale-up")


@phase("12c. rolling hot swaps, a checkpoint and a resume")
def phase_hot_swap(torch, results):
    """``--replicas 2 --hot-swap-every 64 --ckpt-dir``, then a second run
    on the same directory: it resumes the saved version; the same 32 nodes
    served in one batch (by a server without a cache, so both answers are
    computed alike) under the weights before the save and under the
    restored ones are bitwise equal."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.serving import GNNInferenceServer
    from repro_torch.serving.batcher import MicroBatch
    ckpt = os.path.join(ROOT, "chiprun_out", f"ckpt_{os.getpid()}")
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        first, s1 = router_run(torch, "--hot-swap-every 64 --ckpt-dir", [
            "--requests", "256", "--replicas", "2", "--hot-swap-every",
            "64", "--ckpt-dir", ckpt])
        saved = first["params_version"]
        s1["launches"] = require_k1_per_forward(
            torch, "hot swaps", first["router"].forward_calls)
        require(first["hot_swaps"] >= 1 and saved == first["hot_swaps"],
                f"hot swaps happened: {s1}")
        require(latest_step(ckpt) == saved, f"step {saved} saved")
        second, s2 = router_run(torch, "resumed from --ckpt-dir", [
            "--requests", "256", "--replicas", "2", "--ckpt-dir", ckpt])
        r1, r2 = first["router"], second["router"]
        versions = {int(v) for v in second["version_counts"]}
        require(r2.version == saved and versions <= {0, saved},
                f"the second run resumed version {saved}: {s2}")
        sd1, sd2 = r1.params.state_dict(), r2.params.state_dict()
        require(list(sd1) == list(sd2)
                and all(torch.equal(sd1[k], sd2[k]) for k in sd1),
                "restored weights bitwise equal to the saved ones")
        ids = np.full(BUCKET, -1, np.int64)
        ids[:32] = sorted(PHASE3_LOGITS)[:32]
        answers, forwards = [], r2.forward_calls
        for router in (r1, r2):
            srv = GNNInferenceServer(
                router.g, router.cfg, router.params, fanouts=list(FANOUTS),
                buckets=[BUCKET], cache_policy="none", seed=0)
            answers.append(srv.serve_batch(MicroBatch([], ids, BUCKET, 0.0))
                           [:32])
            forwards += srv.forward_calls
        same = bool(np.array_equal(answers[0], answers[1]))
        results["replicas.hot_swap"] = {
            "first": s1, "second": s2, "restored_bitwise": same,
            "launches": require_k1_per_forward(torch, "resume", forwards)}
        print(f"   version {saved} saved and resumed; 32 nodes under the "
              f"restored weights bitwise equal: {same}", flush=True)
        require(same, "answers under the restored weights bitwise equal")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


@phase("12d. replicated SAGE serving over a changing graph")
def phase_replica_updates(torch, g, results):
    """``--replicas 2 --update-stream`` on phase 11(d)'s stream (128
    requests, staleness 4): every event folded into the fleet's graph,
    then a replica of the updated router against a cold server built on
    ``log.apply(g)`` with the same weights, within 1e-5."""
    from repro_torch.core.updates import load_update_stream, synthesize_updates
    from repro_torch.serving import GNNInferenceServer
    from repro_torch.serving.batcher import MicroBatch
    path = os.path.join(ROOT, "chiprun_out", "updates.jsonl")
    if not os.path.exists(path):          # phase 11(d) did not write it
        synthesize_updates(g, UPDATE_EVENTS, seed=11).to_jsonl(path)
    log = load_update_stream(path)
    res, summary = router_run(torch, "--replicas 2 --update-stream", [
        "--requests", "128", "--replicas", "2", "--staleness", "4",
        "--update-stream", path])
    router = res["router"]
    require(res["update_seq"] == log.last_seq,
            f"every event folded ({res['update_seq']} of {log.last_seq})")
    cold = GNNInferenceServer(
        log.apply(g), router.cfg, router.params, fanouts=list(FANOUTS),
        buckets=[BUCKET], cache_policy="degree",
        cache_capacity=int(NODES * 0.2), max_staleness=4, seed=0)
    cold.warmup()
    touched = log.delta(0).nodes
    rng = np.random.default_rng(12)
    others = np.setdiff1d(rng.choice(NODES, 256, replace=False), touched)
    seeds = np.concatenate([touched[:128], others[:128]])
    srv = router.replicas[0].server
    worst, top = 0.0, 0.0
    for start in range(0, len(seeds), BUCKET):
        ids = np.full(BUCKET, -1, np.int64)
        chunk = seeds[start:start + BUCKET]
        ids[:len(chunk)] = chunk
        a = srv.serve_batch(MicroBatch([], ids, BUCKET, 0.0))[:len(chunk)]
        b = cold.serve_batch(MicroBatch([], ids, BUCKET, 0.0))[:len(chunk)]
        worst = max(worst, float(np.abs(a - b).max()))
        top = max(top, float(np.abs(b).max()))
    summary.update(update_seq=res["update_seq"], delta_vs_cold_max_abs=worst,
                   cold_max_abs=top, launches=require_k1_per_forward(
                       torch, "update stream", router.forward_calls
                       + cold.forward_calls))
    print(f"   the updated fleet vs a cold server on log.apply(g), "
          f"{len(seeds)} seeds: max |diff| {worst:.3e} (max |logit| "
          f"{top:.3e})", flush=True)
    results["replicas.update_stream"] = summary
    require(worst <= 1e-5, f"updated fleet within 1e-5 of a cold rebuild "
            f"({worst})")


# ---------------------------------------------------------------------------
# transformer serving: Phi-3-mini-3.8B (dense, K7) and Mamba2-780m (ssm,
# K8) at their published widths, bf16 as their configs state
# ---------------------------------------------------------------------------

PHI3, MAMBA2 = "phi3-mini-3.8b", "mamba2-780m"
# phase 13's dense configs: QKV bias and G 5 (Qwen2.5-14B, 40 / 8 x 128),
# GeGLU with tied, scaled embeddings at hd 256 (Gemma-7B, 16 / 16 x 256),
# partial rotary and G 16 (GLM-4-9B, 32 / 2 x 128)
ZOO = ("qwen2.5-14b", "gemma-7b", "glm4-9b")
# phase 13's float32 prefill against the decode-only loop runs on a cut of
# this many layers at full width (Qwen2.5-14B's float32 weights at full
# depth, about 59 GB, do not fit beside the rest)
ZOO_FP32_LAYERS = 4
LM_BATCH, LM_PROMPT, LM_GEN = 8, 1024, 32
# the configs phases 9 and 10 serve: empty, the published ones (32 and 48
# layers, one K7 or K8 launch each per prefill).  A rehearsal off the card
# puts small configs here and cuts LM_BATCH, LM_PROMPT, LM_GEN; the
# launcher in (a) then serves its --reduced config.
LM_CONFIGS: dict = {}
LM_KERNEL = {PHI3: "flash_attention", MAMBA2: "ssd_chunk_state"}
# the counter of the same kernel's float32 launches (K7's TF32 split route,
# K8's CUDA-core route)
LM_KERNEL_FP32 = {PHI3: "flash_attention_fp32",
                  MAMBA2: "ssd_chunk_state_fp32"}
# prefill tok/s of PR 14's first full run (PERF.md section 5: K8 still on
# the CUDA cores), printed beside this run's for comparison
EARLIER_PREFILL_TOK_S = {PHI3: 42294.0, MAMBA2: 26610.0}
# K7's bf16 outputs: both sides round one float32 result to bf16, so an
# element may differ by one bf16 ulp, at most 2**-7 of its plain value,
# plus the float32 sums' own difference (far below 1e-5 of the largest
# value); the kernel also rounds P to bf16 (unit roundoff 2**-8) for the
# PV product, as the TPU kernel's default-precision dot and FlashAttention
# do, which moves an output by at most 2**-8 * sum_j p_j |v_j| / l, that
# is 2**-8 times the plain version on |v|.  A dropped key tile moves a
# late row by several percent of its value, many ulps
BF16_ULP_REL, BF16_ATOL_REL, BF16_P_REL = 2.0 ** -7, 1e-5, 2.0 ** -8
# prefill against the decode-only loop at the last prompt position, full
# depth.  float32: max abs gap within LM_FP32_REL of the largest logit.
# Phi-3's paths differ by 3.0e-6 of it on the card; Mamba2's by 2.8e-4 to
# 5.2e-4 on the card and 3.9e-4 on the host's CPU (no kernel there), and
# the reference's own two paths at Mamba2's full width grow alike with
# depth (7.3e-6 at 2 layers, 9.0e-5 at 12, 4.3e-4 at 24, on the CPU:
# tests/test_torch_reference_gap.py), so that gap is the algorithms'
# float32 roundoff, not the port's.  The control, the decode loop reading
# the last or the 8th last token changed, moves the logits by 1.3-1.45 of
# the largest (launch/prefill_gap.py --flip; a token 64 back no longer
# shows: the random weights' SSM forgets within tens of positions).
# Mamba2's limit sits about 6x above its largest sound reading and far
# below the control; Phi-3's is 1e-3.  bf16: random weights amplify bf16 roundoff through the depth:
# the reference's own two paths differ by an RMS ratio |a - b| / |b| of
# 0.017 (Phi-3) and 0.30 (Mamba2), each about as far from the float32
# result, where an unrelated output gives about 1.4; the bounds are 2-6x
# the reference's.
LM_FP32_REL = {PHI3: 1e-3, MAMBA2: 3e-3}
LM_BF16_RMS = {PHI3: 0.1, MAMBA2: 0.6}
# the 2-layer float32 cut on the card and the CPU: (batch, tokens); Mamba2
# takes two SSD chunks of 256
LM_CUT = {PHI3: (2, 256), MAMBA2: (2, 512), **{a: (2, 256) for a in ZOO}}


def k7_case(torch, c, label, B, H, K, Sq, Skv, hd, *, window=0,
            causal=True, dtype=None, timed=True):
    """K7 on (B, S, H, hd) tensors passed as (B, H, S, hd) views, as the
    model passes them, against its plain version; the library call is
    ``scaled_dot_product_attention`` with the same mask."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    dtype = dtype or torch.bfloat16
    q = c.randn(B, Sq, H, hd).to(dtype).transpose(1, 2)
    k = c.randn(B, Skv, K, hd).to(dtype).transpose(1, 2)
    v = c.randn(B, Skv, K, hd).to(dtype).transpose(1, 2)
    qpos = torch.arange(Sq, device=c.dev)[:, None] + (Skv - Sq)
    kpos = torch.arange(Skv, device=c.dev)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=c.dev)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    pairs = int(mask.sum())
    sdpa_kw = ({"is_causal": True} if causal and not window and Sq == Skv
               else {"attn_mask": mask})
    bf16 = dtype == torch.bfloat16
    p_term = (BF16_P_REL * fa.flash_attention_plain(
        q.float(), k.float(), v.float().abs(), causal=causal, window=window)
        if bf16 else None)
    return check_case(
        torch, label, functools.partial(fa.flash_attention_cuda,
                                        causal=causal, window=window),
        functools.partial(fa.flash_attention_plain, causal=causal,
                          window=window), (q, k, v), timed=timed,
        library=lambda: F.scaled_dot_product_attention(
            q, k, v, enable_gqa=H != K, **sdpa_kw),
        bytes_=q.element_size() * (2 * B * H * Sq * hd + 2 * B * K * Skv * hd),
        flops=4.0 * B * H * pairs * hd, flush=c.flush,
        rel=BF16_ATOL_REL if bf16 else 1e-4,
        elem_rel=BF16_ULP_REL if bf16 else None, elem_abs=p_term,
        peak=BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S)


def k8_case(torch, c, label, C, L, H, P, G, N, *, dtype=None, timed=True):
    """K8 on the views the model passes (x and Bm slices of one (C, L,
    conv_dim) tensor; dt and A in float32) against its plain version
    (1e-4 of the largest value in every route); the library call is the
    reference's einsum on its precomputed operands.  float32's bound
    takes its flops at the TF32 tensor-core rate, as K7's does."""
    from repro_torch.kernels import ssd_chunk as sc
    dtype = dtype or torch.bfloat16
    xBC = c.randn(C, L, H * P + 2 * G * N).to(dtype)
    x = xBC[..., :H * P].reshape(C, L, H, P)
    Bm = xBC[..., H * P:H * P + G * N].reshape(C, L, G, N)
    dt = torch.nn.functional.softplus(c.randn(C, L, H))
    A = -torch.arange(1, H + 1, dtype=torch.float32, device=c.dev)
    Bh = Bm.repeat_interleave(H // G, dim=2).float()
    cum = torch.cumsum(dt * A, dim=1)
    decay = torch.exp(cum[:, -1:, :] - cum)
    xdt = x.float() * dt[..., None]
    print(f"   {label}: route {sc.launch_plan(x, Bm)['counter']}")
    return check_case(
        torch, label, sc.ssd_chunk_state_cuda, sc.ssd_chunk_state_plain,
        (x, dt, A, Bm), timed=timed,
        library=lambda: torch.einsum("blhn,blh,blhp->bhpn", Bh, decay, xdt),
        bytes_=(x.element_size() * (C * L * H * P + C * L * G * N)
                + 4 * (C * L * H + H + C * H * P * N)),
        flops=2.0 * C * H * L * P * N + 4.0 * C * L * H, flush=c.flush,
        peak=BF16_FLOPS_PER_S if dtype == torch.bfloat16
        else TF32_FLOPS_PER_S)


@phase("8. K7 flash attention and K8 SSD chunk state vs plain versions")
def phase_lm_kernels(torch, results):
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import layers as TL
    c = Checker(torch, seed=8)
    S, Bsz, Sd = LM_PROMPT, LM_BATCH, LM_PROMPT + LM_GEN
    cases = (
        ("", (f"K7 Phi-3-mini prefill (B {Bsz}, S {S}, 32 x 96, causal)",
              Bsz, 32, 32, S, S, 96), {}),
        (".gqa", (f"K7 G 5, hd 128 (Qwen2.5-14B's 40/8 heads; B 2, S {S})",
                  2, 40, 8, S, S, 128), {}),
        (".window", ("K7 Phi-3-mini prefill shape, window 256", Bsz, 32, 32,
                     S, S, 96), {"window": 256}),
        (".sq_lt_skv", (f"K7 Sq 64 < Skv {Sd}, queries at the end", Bsz, 32,
                        32, 64, Sd, 96), {}),
        (".sq1", (f"K7 Sq 1, Skv {Sd}", Bsz, 32, 32, 1, Sd, 96), {}))
    # every head width the kernel takes, a non-causal call, ragged query
    # and key tiles
    untimed = (
        (("K7 hd 64, G 4, S 200", 2, 8, 2, 200, 200, 64), {}),
        (("K7 hd 96, S 200", 2, 4, 4, 200, 200, 96), {}),
        (("K7 hd 128, G 2, S 200", 2, 4, 2, 200, 200, 128), {}),
        (("K7 hd 256 (Gemma-7B's heads), S 300", 1, 16, 16, 300, 300, 256),
         {}),
        (("K7 non-causal, Sq 48 < Skv 96, hd 64", 2, 4, 4, 48, 96, 64),
         {"causal": False}),
        (("K7 window 40, S 130", 1, 4, 2, 130, 130, 96), {"window": 40}))
    # the head widths first: a wgmma descriptor or swizzle that does not
    # match its TMA map shows as wrong values at one width
    for args, kw in untimed:
        for name, dtype in (("bf16", torch.bfloat16),
                            ("float32", torch.float32)):
            k7_case(torch, c, f"{args[0]}, {name}", *args[1:], **kw,
                    dtype=dtype, timed=False)
    for key, args, kw in cases:
        results["flash_attention" + key] = k7_case(
            torch, c, args[0] + ", bf16", *args[1:], **kw)
    results["flash_attention_fp32"] = k7_case(
        torch, c, cases[0][1][0] + ", float32", *cases[0][1][1:],
        dtype=torch.float32)
    # the prefill shapes of phase 13's configs, timed in bf16 (the route
    # their served prefill takes) and checked in float32 (their cut's)
    for arch in ZOO:
        cfg = LM_CONFIGS.get(arch) or get_config(arch)
        shape = (Bsz, cfg.num_heads, cfg.num_kv_heads, S, S,
                 cfg.resolved_head_dim)
        label = (f"K7 {cfg.name} prefill (B {Bsz}, S {S}, {shape[1]} / "
                 f"{shape[2]} x {shape[5]}, causal)")
        results[f"flash_attention.{arch}"] = k7_case(
            torch, c, label + ", bf16", *shape)
        k7_case(torch, c, label + ", float32", *shape, dtype=torch.float32,
                timed=False)
    # every case in both dtypes: float32 holds the CUDA-core kernel to
    # 1e-4 of the largest value at each head width and mask
    for _, args, kw in cases[1:]:
        k7_case(torch, c, args[0] + ", float32", *args[1:], **kw,
                dtype=torch.float32, timed=False)
    C = Bsz * S // 256
    results["ssd_chunk_state"] = k8_case(
        torch, c, f"K8 Mamba2-780m prefill ({C} chunks x 256, 48 x 64, N "
        f"128, G 1, bf16)", C, 256, 48, 64, 1, 128)
    results["ssd_chunk_state.g2"] = k8_case(
        torch, c, "K8 Mamba2 prefill shape, G 2", C, 256, 48, 64, 2, 128)
    results["ssd_chunk_state_fp32"] = k8_case(
        torch, c, "K8 Mamba2 prefill shape, G 1, float32", C, 256, 48, 64, 1,
        128, dtype=torch.float32)
    k8_case(torch, c, "K8 float32, L 100, 8 x 32, N 24, G 2", 6, 100, 8, 32,
            2, 24, dtype=torch.float32, timed=False)
    # ragged chunks in bf16 (positions past L arrive as zeros), and more
    # chunks than SMs (a block then walks 16 heads, the most it takes)
    for G in (1, 2):
        k8_case(torch, c, f"K8 bf16, L 100, 48 x 64, N 128, G {G}", 6, 100,
                48, 64, G, 128, timed=False)
    k8_case(torch, c, "K8 bf16, L 7", 3, 7, 48, 64, 1, 128, timed=False)
    k8_case(torch, c, "K8 bf16, 160 chunks x 256", 160, 256, 48, 64, 1,
            128, timed=False)
    # N 64 on the tensor cores: Zamba2-2.7B's SSM widths (80 heads x 64,
    # state 64, chunk 256) at the same prefill, then ragged
    results["ssd_chunk_state.n64"] = k8_case(
        torch, c, f"K8 Zamba2-2.7B widths ({C} chunks x 256, 80 x 64, N 64, "
        f"G 1, bf16)", C, 256, 80, 64, 1, 64)
    k8_case(torch, c, "K8 bf16, L 100, 8 x 64, N 64, G 2", 6, 100, 8, 64, 2,
            64, timed=False)
    k8_case(torch, c, "K8 bf16, N 64, 160 chunks x 256, 64 x 64 (a block "
            "walks 32 heads, the most it takes at N 64)", 160, 256, 64, 64,
            1, 64, timed=False)
    # bf16 off the tensor-core tile goes to the CUDA-core kernel: the
    # reduced configs' widths (8 x 32, N 16, chunk 16; timed) and a chunk
    # of 300
    results["ssd_chunk_state_bf16_cuda_core"] = k8_case(
        torch, c, "K8 bf16, L 16, 8 x 32, N 16, G 2", 6, 16, 8, 32, 2, 16)
    k8_case(torch, c, "K8 bf16, L 300, 8 x 64, N 128, G 1", 3, 300, 8, 64,
            1, 128, timed=False)
    # the calls K7 does not compute raise on the card, naming the ROADMAP
    # item, and never run the plain version
    q, kv = c.randn(1, 4, 2, 64), c.randn(1, 8, 2, 64)
    for what, kw in (("q_offset != Skv - Sq", {"q_offset": 0}),
                     ("kv_valid_len", {"q_offset": 4, "kv_valid_len": 6})):
        try:
            TL.attention(q, kv, kv, causal=True, **kw)
        except NotImplementedError as e:
            print(f"   attention with {what} on the card refused: {e}")
        else:
            raise RuntimeError(f"check failed: attention with {what} ran "
                               f"on the card")


def _with_room(torch, cache, n):
    """prefill's cache (the prompt's S positions, as the reference's) with
    ``n`` zero slots more for the decode steps that follow; an SSM cache
    holds no positions."""
    if "k" not in cache:
        return cache
    return {k: torch.cat([c, c.new_zeros(c.shape[:2] + (n,) + c.shape[3:])],
                         dim=2) for k, c in cache.items()}


def lm_profile(torch, label, step, wall_s) -> dict:
    """Device time of one ``step`` by kind (the port's kernel, matrix
    products, copies, the rest), as the active step after a profiled
    warm-up step, beside the step's wall time ``wall_s``."""
    def kind(key):
        k = key.lower()
        if any(n in k for n in ("flash_fwd_wgmma_kernel",
                                "flash_fwd_tf32_kernel", "ssd_state_kernel",
                                "ssd_state_wgmma_kernel")):
            return "port kernel"
        if any(n in k for n in ("gemm", "gemv", "cutlass", "xmma", "sm90_",
                                "sm80_", "ampere_", "matmul", "nvjet",
                                "splitk")):
            return "matrix products"
        if k.startswith(("memcpy", "memset")):
            return "copies"
        return "elementwise and reductions"

    rows = device_rows(profile_active_step(torch, step))
    split = {}
    for e in rows:
        split[kind(e.key)] = split.get(kind(e.key), 0.0) + dev_us(e) / 1e3
    total = sum(split.values())
    print(f"   (c) {label} profiled: device {total:.3f} ms of "
          f"{wall_s * 1e3:.3f} ms wall ({total / (wall_s * 1e3):.2%} busy); "
          f"split (ms): " + json.dumps(split), flush=True)
    for e in rows[:10]:
        print(f"   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} "
              f"{kind(e.key)[:12]:12s} {e.key[:80]}")
    return {"device_ms": total, "wall_ms": wall_s * 1e3, "split_ms": split,
            "kernels": [{"kernel": e.key, "count": e.count,
                         "ms": dev_us(e) / 1e3} for e in rows[:40]]}


def _to_cuda(tree):
    """A copy of a param tree (dicts, lists, tensors) on the card."""
    if isinstance(tree, dict):
        return {k: _to_cuda(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cuda(v) for v in tree]
    return tree.cuda()


def lm_cut_parity(torch, cfg, arch) -> dict:
    """(d) A 2-layer float32 cut at full width, the same weights and tokens
    on the card and on the CPU: forward, prefill and two decode steps
    agree within 1e-4 of the largest CPU logit."""
    from repro_torch.models.transformer import model as M
    cut = cfg.replace(num_layers=2, param_dtype="float32",
                      compute_dtype="float32")
    B, S = LM_CUT[arch]
    cpu = M.init_params(cut, torch.Generator().manual_seed(3), device="cpu")
    dev = _to_cuda(cpu)
    tok = torch.randint(0, cut.vocab_size, (B, S),
                        generator=torch.Generator().manual_seed(4))
    outs = {}
    for name, params, t in (("cuda", dev, tok.cuda()), ("cpu", cpu, tok)):
        with torch.inference_mode():
            lg = [M.forward(cut, params, {"tokens": t})]
            last, cache = M.prefill(cut, params, {"tokens": t})
            cache = _with_room(torch, cache, 2)
            lg.append(last)
            for i in range(2):
                last, cache = M.decode_step(cut, params, cache,
                                            {"token": t[:, i:i + 1],
                                             "pos": S + i})
                lg.append(last)
        outs[name] = [x.float().cpu() for x in lg]
    res = {}
    for what, a, b in zip(("forward", "prefill", "decode 1", "decode 2"),
                          outs["cuda"], outs["cpu"]):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        res[what] = {"max_abs_err": err, "max_abs_cpu": scale}
        require(bool(torch.isfinite(a).all()) and err <= 1e-4 * scale,
                f"2-layer float32 cut, {what}: card vs CPU {err} (max|cpu| "
                f"{scale})")
    print(f"   (d) 2-layer float32 cut ({B} x {S}), card vs CPU: "
          + json.dumps(res), flush=True)
    return res


def lm_phase(torch, arch, results):
    """One model's serving checks: (a) the serving launcher's decode-only
    loop; (b) prefill of LM_BATCH x LM_PROMPT tokens and LM_GEN decode
    steps from its cache with exactly one K7 (Phi-3) or K8 (Mamba2)
    launch per layer, and prefill against the decode-only loop at full
    depth, in float32 and in bf16; (c) a profile of one prefill; (d) a
    2-layer float32 cut on the card and on the CPU."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.launch.prefill_gap import decode_loop, gap
    from repro_torch.models.transformer import model as M
    dev = torch.device("cuda")
    cfg = LM_CONFIGS.get(arch) or get_config(arch)
    V, key, nl = cfg.vocab_size, LM_KERNEL[arch], cfg.num_layers
    out: dict = {}

    # (a) the reference's serving loop, through the launcher
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res = serve.run(["--arch", arch, "--batch", str(LM_BATCH),
                     "--prompt-len", "64", "--gen", "32"]
                    + (["--reduced"] if arch in LM_CONFIGS else []))
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    out["serve"] = {"prefill_tok_s": res["prefill_tok_s"],
                    "decode_tok_s": res["decode_tok_s"],
                    "params": res["params"], "launches": counts,
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                    "first_tokens": res["tokens"][0, :8].tolist()}
    print(f"   (a) launch.serve (the loop serve.main runs), decode-only, "
          f"{LM_BATCH} x 64 prompt tokens + 32: "
          + json.dumps(out["serve"]), flush=True)
    require(res["tokens"].shape == (LM_BATCH, 32), "32 tokens per sequence")
    require(bool(torch.isfinite(res["logits"].float()).all()),
            "finite decode logits")
    require(not counts, f"the decode-only loop launches no kernel: {counts}")
    del res

    prompts = torch.randint(0, V, (LM_BATCH, LM_PROMPT), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    with torch.inference_mode():
        # float32 weights at full depth: prefill against the decode-only
        # loop, two of the prompts
        cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
        p32 = M.init_params(cfg32, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        ops.reset_launch_counts()
        lg32, _ = M.prefill(cfg32, p32, {"tokens": prompts[:2]})
        counts32 = {k: v for k, v in ops.launch_counts().items() if v}
        results[f"launches.lm_fp32.{arch}"] = counts32
        n32 = counts32.get(LM_KERNEL_FP32[arch], 0)
        g = gap(lg32[:, :V], decode_loop(cfg32, p32, prompts[:2])[:, :V])
        out["fp32_prefill_vs_decode"] = g
        print(f"   float32, 2 x {LM_PROMPT}: prefill vs the decode-only loop "
              + json.dumps(g), flush=True)
        require(counts32 == {LM_KERNEL_FP32[arch]: nl},
                f"{LM_KERNEL_FP32[arch]} launched {n32} times (all "
                f"launches: {counts32}) in a float32 prefill of {nl} "
                f"layers")
        require(g["max_abs"] <= LM_FP32_REL[arch] * g["max_abs_ref"],
                f"float32 prefill agrees with the decode-only loop: {g}")

        # (b) bf16, the same weights rounded
        params = M.cast_params(cfg, p32)
        del p32, lg32
        torch.cuda.empty_cache()
        M.prefill(cfg, params, {"tokens": prompts[:, :256]})      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = M.prefill(cfg, params, {"tokens": prompts})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        peak_prefill = torch.cuda.max_memory_allocated()
        # the peaks leave out the copy that grows the cache
        cache = _with_room(torch, cache, LM_GEN)
        torch.cuda.reset_peak_memory_stats()
        first = logits
        finite = bool(torch.isfinite(logits.float()).all())
        tok = torch.argmax(logits[:, :V], -1)[:, None]
        t0 = time.perf_counter()
        for i in range(LM_GEN):
            logits, cache = M.decode_step(cfg, params, cache,
                                          {"token": tok,
                                           "pos": LM_PROMPT + i})
            tok = torch.argmax(logits[:, :V], -1)[:, None]
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        finite = finite and bool(torch.isfinite(logits.float()).all())
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        results[f"launches.lm.{arch}"] = counts
        out["prefill"] = {
            "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
            "prefill_ms": t_prefill * 1e3,
            "prefill_tok_s": LM_BATCH * LM_PROMPT / t_prefill,
            "decode_ms_per_step": t_decode / LM_GEN * 1e3,
            "decode_tok_s": LM_BATCH * LM_GEN / t_decode,
            "max_memory_allocated": max(peak_prefill,
                                        torch.cuda.max_memory_allocated()),
            "cache_bytes": sum(t.numel() * t.element_size()
                               for t in cache.values()),
            "launches": counts}
        print(f"   (b) prefill {LM_BATCH} x {LM_PROMPT}, then {LM_GEN} "
              f"decode steps: " + json.dumps(out["prefill"]), flush=True)
        print(f"   prefill {out['prefill']['prefill_tok_s']:.0f} tok/s; PR "
              f"14's run (PERF.md): {EARLIER_PREFILL_TOK_S[arch]:.0f} tok/s",
              flush=True)
        require(finite, "finite prefill and decode logits")
        require(counts == {key: nl}, f"one prefill and {LM_GEN} decode "
                f"steps launch {key} exactly {nl} times: {counts}")
        # the last decode step again (it rewrites its own cache slot)
        out["profile_decode"] = lm_profile(
            torch, "one decode step", lambda: M.decode_step(
                cfg, params, cache, {"token": tok,
                                     "pos": LM_PROMPT + LM_GEN - 1}),
            t_decode / LM_GEN)
        del cache
        g = gap(first[:, :V], decode_loop(cfg, params, prompts)[:, :V])
        out["bf16_prefill_vs_decode"] = g
        print(f"   bf16: prefill vs the decode-only loop at position "
              f"{LM_PROMPT - 1}: " + json.dumps(g) + f" (bound: RMS ratio "
              f"{LM_BF16_RMS[arch]})", flush=True)
        require(g["rms_ratio"] <= LM_BF16_RMS[arch],
                f"bf16 prefill agrees with the decode-only loop: {g}")

        out["profile"] = lm_profile(
            torch, "one prefill",
            lambda: M.prefill(cfg, params, {"tokens": prompts}), t_prefill)
    del params
    torch.cuda.empty_cache()
    out["cut"] = lm_cut_parity(torch, cfg, arch)
    results[f"lm.{arch}"] = out


@phase("9. serve Phi-3-mini-3.8B at full width, bf16")
def phase_phi3(torch, results):
    lm_phase(torch, PHI3, results)


@phase("10. serve Mamba2-780m at full width, bf16")
def phase_mamba2(torch, results):
    lm_phase(torch, MAMBA2, results)


def zoo_phase(torch, arch, results):
    """One of phase 13's dense configs: (a) float32 at full width on a
    ZOO_FP32_LAYERS-layer cut, prefill against the decode-only loop
    within 1e-3 of the largest logit, K7's float32 route once a layer;
    (b) bf16 at full width and depth: a LM_BATCH x LM_PROMPT prefill
    launching K7's bf16 route exactly once a layer, LM_GEN decode steps
    in its grown cache, finite logits, tok/s and peak memory; (c) a
    2-layer float32 cut on the card and on the CPU (``lm_cut_parity``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.prefill_gap import decode_loop, gap
    from repro_torch.models.transformer import model as M
    dev = torch.device("cuda")
    cfg = LM_CONFIGS.get(arch) or get_config(arch)
    V, nl = cfg.vocab_size, cfg.num_layers
    out: dict = {}
    prompts = torch.randint(0, V, (LM_BATCH, LM_PROMPT), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(1))
    with torch.inference_mode():
        cut = cfg.replace(num_layers=min(ZOO_FP32_LAYERS, nl),
                          param_dtype="float32", compute_dtype="float32")
        p32 = M.init_params(cut, torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        ops.reset_launch_counts()
        lg32, _ = M.prefill(cut, p32, {"tokens": prompts[:2]})
        counts32 = {k: v for k, v in ops.launch_counts().items() if v}
        results[f"launches.lm_fp32.{arch}"] = counts32
        g = gap(lg32[:, :V], decode_loop(cut, p32, prompts[:2])[:, :V])
        out["fp32_cut_prefill_vs_decode"] = dict(g, layers=cut.num_layers,
                                                 launches=counts32)
        print(f"   (a) float32, {cut.num_layers}-layer cut, 2 x {LM_PROMPT}: "
              f"prefill vs the decode-only loop " + json.dumps(g),
              flush=True)
        require(counts32 == {"flash_attention_fp32": cut.num_layers},
                f"K7's float32 route once a layer of the cut: {counts32}")
        require(g["max_abs"] <= 1e-3 * g["max_abs_ref"],
                f"float32 prefill agrees with the decode-only loop: {g}")
        del p32, lg32
        torch.cuda.empty_cache()

        params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
        M.prefill(cfg, params, {"tokens": prompts[:, :256]})      # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = M.prefill(cfg, params, {"tokens": prompts})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        results[f"launches.lm.{arch}"] = counts
        peak_prefill = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(logits.float()).all())
        cache = _with_room(torch, cache, LM_GEN)
        torch.cuda.reset_peak_memory_stats()
        tok = torch.argmax(logits[:, :V], -1)[:, None]
        t0 = time.perf_counter()
        for i in range(LM_GEN):
            logits, cache = M.decode_step(cfg, params, cache,
                                          {"token": tok,
                                           "pos": LM_PROMPT + i})
            tok = torch.argmax(logits[:, :V], -1)[:, None]
        torch.cuda.synchronize()
        t_decode = time.perf_counter() - t0
        finite = finite and bool(torch.isfinite(logits.float()).all())
        decode_counts = {k: v for k, v in ops.launch_counts().items() if v}
        out["prefill"] = {
            "batch": LM_BATCH, "prompt": LM_PROMPT, "gen": LM_GEN,
            "params": M.param_count(params),
            "prefill_ms": t_prefill * 1e3,
            "prefill_tok_s": LM_BATCH * LM_PROMPT / t_prefill,
            "decode_ms_per_step": t_decode / LM_GEN * 1e3,
            "decode_tok_s": LM_BATCH * LM_GEN / t_decode,
            "max_memory_allocated": max(peak_prefill,
                                        torch.cuda.max_memory_allocated()),
            "cache_bytes": sum(t.numel() * t.element_size()
                               for t in cache.values()),
            "launches": counts}
        print(f"   (b) bf16, {nl} layers: prefill {LM_BATCH} x {LM_PROMPT}, "
              f"then {LM_GEN} decode steps: " + json.dumps(out["prefill"]),
              flush=True)
        require(finite, "finite prefill and decode logits")
        require(counts == {"flash_attention": nl} and decode_counts == counts,
                f"a prefill launches K7's bf16 route once a layer ({nl}) and "
                f"the decode steps none: {counts}, {decode_counts}")
        del params, cache, logits
    torch.cuda.empty_cache()
    out["cut"] = lm_cut_parity(torch, cfg, arch)
    results[f"lm.{arch}"] = out


# ---------------------------------------------------------------------------
# phase 14: distributed full-graph GCN, 4 ranks on the one card
# ---------------------------------------------------------------------------

DIST_WORLD = 4
# the synchronous modes (stale and hysync with a 3-epoch snapshot), two
# pull runs for the bitwise repeat, then the asynchronous trainer
DIST_SYNC = (("pull", []), ("pull_again", []), ("push", ["--mode", "push"]),
             ("stale", ["--mode", "stale", "--staleness", "3"]),
             ("hysync", ["--mode", "hysync", "--staleness", "3"]))
DIST_ASYNC = (("async_s0", ["--staleness", "0"]),
              ("async_s1", ["--staleness", "1"]),
              ("async_s4", ["--staleness", "4"]),
              ("async_s1_int8", ["--staleness", "1", "--wire-codec",
                                 "int8"]))
# the update-stream run: phase 11(d)'s stream in 4 folds over 5 epochs
DIST_STREAM_EPOCHS, DIST_STREAM_PER_EPOCH = 5, 500
# Parameters after 10 AdamW epochs: AdamW divides each gradient element
# by its own running magnitude, so a nearly cancelled element moves by
# far more than its rounding, and another order of summation over 233 k
# rows moves the parameters by float32's own error on the problem.
# Phase 14 reads it in every run (phase 6's float32 GCN and pull against
# the same GCN in float64: 1.3e-4 and 2.4e-4 on an H100), beside two
# wrong paths (DIST_FAULTS: 2.2e-2 and 1.1e-1), and requires the sound
# readings within the bound and the wrong ones above it.  Under SGD (lr
# 0.1) every mode is held to 1e-5, the first 4 losses to the
# reference's 1e-4.
DIST_ADAMW_PARAM_TOL, DIST_SGD_TOL, DIST_LOSS_TOL = 1e-3, 1e-5, 1e-4
DIST_SGD_LR = 0.1
DIST_SGD_MODES = ("pull", "push", "stale", "hysync", "async_s0")
# pull with a fault put in for one job: every all-gathered row rounded
# to bf16 (straight-through), or the last rank's gradient left out of
# the sum
DIST_FAULTS = ("bf16_gather", "rank_gradient_dropped")


def dist_args(mode_flags, epochs=TRAIN_EPOCHS):
    return train_args("gcn", CLASSES, ["--devices", str(DIST_WORLD),
                                       "--epochs", str(epochs),
                                       *mode_flags])


def dist_coordination_job(rank, world, dev):
    """Both coordinators (``core/coordination.py``) from the same
    parameters, at GCN's Reddit shapes, on each rank's own random
    gradients, three AdamW steps each: the largest parameter difference
    (the reference's bound is 1e-5)."""
    import torch
    from repro_torch.core import coordination
    from repro_torch.optim import AdamW
    shapes = [(FEAT, HIDDEN), (HIDDEN,), (HIDDEN, CLASSES), (CLASSES,)]
    gen = torch.Generator().manual_seed(0)
    init = [torch.randn(s, generator=gen) for s in shapes]
    gen = torch.Generator().manual_seed(1 + rank)
    grads = [torch.randn(s, generator=gen).to(dev) for s in shapes]
    out = {}
    for name, fn in coordination.COORDINATORS.items():
        ps = [torch.nn.Parameter(t.clone().to(dev)) for t in init]
        opt = AdamW(ps, lr=1e-2, weight_decay=0.0)
        for _ in range(3):
            fn(opt, ps, grads)
        out[name] = [p.detach() for p in ps]
    return {"max_diff": max(float((a - b).abs().max()) for a, b in zip(
        out["decentralized"], out["parameter_server"]))}


def _dist_setup(world, dev, argv):
    """The graph the launcher makes for ``argv`` (a phase-14 job's), its
    GCN config and its hash cut over ``world`` ranks."""
    from repro_torch.core import propagation as PR
    from repro_torch.launch import train_gnn
    from repro_torch.models.gnn import model as GM
    args = train_gnn.parse_args(argv)
    g, _ = train_gnn._rank_graph(args, lambda *a: None)
    cfg = GM.GNNConfig(arch="gcn", feat_dim=g.features.shape[1],
                       hidden=args.hidden, num_classes=g.num_classes)
    return g, cfg, PR.shard_graph(g, world)


def _params_np(model) -> list:
    return [{k: v.detach().cpu().numpy() for k, v in layer.named_parameters()}
            for layer in model]


def dist_sgd_job(rank, world, dev, *, argv):
    """Every synchronous mode and the asynchronous trainer at S 0, 10 SGD
    steps each from phase 6's initial parameters
    (``propagation.run_sync``, ``AsyncFullGraphTrainer.run``): each
    mode's final parameters (numpy)."""
    import torch
    from repro_torch.core import propagation as PR
    from repro_torch.distributed import AsyncFullGraphTrainer
    from repro_torch.models.gnn import model as GM
    from repro_torch.optim import Sgd
    g, cfg, sg = _dist_setup(world, dev, argv)
    out = {}
    for mode in DIST_SGD_MODES:
        model = GM.init_gnn(cfg, torch.Generator().manual_seed(0),
                            device=dev)
        opt = Sgd(model.parameters(), lr=DIST_SGD_LR)
        if mode == "async_s0":
            AsyncFullGraphTrainer(g, cfg, opt, world, staleness=0,
                                  device=dev).run(model, TRAIN_EPOCHS)
        else:
            PR.run_sync(model, opt, sg, g, rank, dev, mode=mode,
                        staleness=3, steps=TRAIN_EPOCHS)
        out[mode] = _params_np(model)
    return out


def dist_fault_job(rank, world, dev, *, argv, fault):
    """Pull, 10 AdamW epochs from phase 6's initial parameters as the
    launcher runs it, with ``fault`` (one of ``DIST_FAULTS``) put into
    ``core/propagation.py`` for this job alone: the final parameters
    (numpy), a wrong path's reading against the AdamW bound."""
    import torch
    from repro_torch.core import propagation as PR
    from repro_torch.models.gnn import model as GM
    from repro_torch.optim import AdamW
    g, cfg, sg = _dist_setup(world, dev, argv)
    model = GM.init_gnn(cfg, torch.Generator().manual_seed(0), device=dev)
    opt = AdamW(model.parameters(), lr=1e-2, weight_decay=0.0)
    saved = PR.pull_aggregate, PR.sum_grads_and_loss

    def bf16_gather(h, shard, *, coef_e=None):
        wire = h.to(torch.bfloat16).to(h.dtype)
        return saved[0](h + (wire - h).detach(), shard, coef_e=coef_e)

    def rank_gradient_dropped(params, loss):
        if rank == world - 1:
            for p in params.parameters():
                p.grad = None
        return saved[1](params, loss)

    if fault == "bf16_gather":
        PR.pull_aggregate = bf16_gather
    else:
        PR.sum_grads_and_loss = rank_gradient_dropped
    try:
        PR.run_sync(model, opt, sg, g, rank, dev, mode="pull",
                    steps=TRAIN_EPOCHS)
    finally:
        PR.pull_aggregate, PR.sum_grads_and_loss = saved
    return {"params": _params_np(model)}


def _single_card(torch, g, optimizer, *, float64=False, device="cuda"):
    """Phase 6's GCN trained 10 steps from its initial parameters by
    ``optimizer`` (``"adamw"``: the launcher's, or ``"sgd"``: lr
    ``DIST_SGD_LR``); under ``float64`` through the kernels' plain
    versions (the kernels take float32): the exact answer every float32
    run is read against.  Its parameters (numpy)."""
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.kernels import segment_sum
    from repro_torch.models.gnn import model as GM
    from repro_torch.optim import AdamW, Sgd
    dev = torch.device(device)
    dtype = torch.float64 if float64 else torch.float32
    cfg = GM.GNNConfig(arch="gcn", feat_dim=FEAT, hidden=HIDDEN,
                       num_classes=CLASSES)
    model = GM.init_gnn(cfg, torch.Generator().manual_seed(0),
                        device=dev).to(dtype)
    opt = (AdamW(model.parameters(), lr=1e-2, weight_decay=0.0)
           if optimizer == "adamw" else Sgd(model.parameters(),
                                            lr=DIST_SGD_LR))
    step = GM.make_fullgraph_train_step(cfg, opt)
    dg = DeviceGraph.from_graph(g, dev, src_layout=True)
    x = torch.from_numpy(g.features).to(dev, dtype)
    y = torch.from_numpy(g.labels).to(dev)
    mask = torch.ones(y.shape, dtype=dtype, device=dev)
    pick = segment_sum.pick
    if float64:
        segment_sum.pick = lambda cuda_fn, plain_fn, t: plain_fn
    try:
        for _ in range(TRAIN_EPOCHS):
            step(model, dg, x, y, mask)
    finally:
        segment_sum.pick = pick
    return _params_np(model)


def _dist_params_diff(a, b) -> float:
    return max(float(np.abs(np.asarray(x[k]) - np.asarray(y[k])).max())
               for x, y in zip(a, b) for k in x)


def _dist_ranks_bitwise(res) -> bool:
    first = res["ranks"][0]["params"]
    return all(np.array_equal(r["params"][i][k], first[i][k])
               for r in res["ranks"] for i in range(len(first))
               for k in first[i])


def _dist_summary(res) -> dict:
    """ms an epoch (host clock, median of epochs 2..: the first builds
    the staging buffers), split into the collectives (staging + gloo
    wait) and the rest, the CUDA-event span, bytes a rank an epoch; each
    a median over the epochs and the ranks' worst."""
    rows = [e for r in res["ranks"] for e in r["epochs"][1:]] or [
        e for r in res["ranks"] for e in r["epochs"]]
    med = lambda k: float(np.median([e[k] for e in rows]))  # noqa: E731
    return {"epoch_ms": med("wall_s") * 1e3,
            "comm_ms": med("comm_s") * 1e3,
            "stage_ms": med("stage_s") * 1e3,
            "wait_ms": med("wait_s") * 1e3,
            "rest_ms": (med("wall_s") - med("comm_s")) * 1e3,
            "event_ms": (med("event_ms") if rows[0]["event_ms"] is not None
                         else None),
            "bytes_received_per_epoch": med("bytes_received"),
            "bytes_sent_per_epoch": med("bytes_sent"),
            "setup_s": max(r["setup_s"] for r in res["ranks"]),
            "losses": res["losses"]}


def _dist_k1_cases(torch, g, results):
    """K1 and K1ᵀ at the distributed shapes of rank 0 (hash, 4 ranks):
    pull ``N_pad -> n_local`` and push ``n_local -> N_pad``, at GCN's
    widths, with the shard's own coefficients."""
    from repro_torch.core import propagation as PR
    c = Checker(torch, seed=14)
    sg = PR.shard_graph(g, DIST_WORLD)
    push = PR.push_layout(sg, g)
    for layout, arrays in (("pull", None), ("push", push)):
        sh = PR.rank_shard(sg, 0, c.dev, push_arrays=arrays)
        dg = sh.graph
        coef = sh.coef * dg.edge_mask.to(torch.float32)
        print(f"   {layout} layout, rank 0: {dg.num_src} sources -> "
              f"{dg.num_dst} destinations, {int(dg.order.numel())} edges",
              flush=True)
        for F in (HIDDEN, CLASSES):
            results[f"k1.dist.{layout}.{F}"] = c.k1(
                f"K1 {layout} layout, F {F} ({dg.num_src} -> "
                f"{dg.num_dst})", c.randn(dg.num_src, F), dg.edge_src,
                coef, dg.order, dg.row_ptr, dg.num_dst)
            results[f"k1_transpose.dist.{layout}.{F}"] = c.k1(
                f"K1 over the src layout, {layout}, F {F} ({dg.num_dst} "
                f"-> {dg.num_src})", c.randn(dg.num_dst, F), dg.edge_dst,
                coef, *dg.src_layout, dg.num_src, transpose=True)


@phase("14. distributed full-graph GCN, 4 ranks on the card")
def phase_distributed(torch, g, results):
    """(a) pull, push, stale (S 3), hysync, 10 epochs each, and (d) the
    asynchronous trainer at S 0, 1, 4 (fp32) and S 1 (int8), then one run
    folding phase 11(d)'s stream, all in one spawned world of 4 ranks on
    the card through ``train_gnn.run_world``; (c) the coordinators inside
    the same world; (b) exact launch counts; (e) times, bytes, and K1 /
    K1ᵀ at the distributed shapes."""
    from repro_torch.core.updates import synthesize_updates
    from repro_torch.launch import train_gnn
    torch.cuda.empty_cache()
    stream = os.path.join(ROOT, "chiprun_out", "updates.jsonl")
    if not os.path.exists(stream):            # phase 11(d) did not run
        os.makedirs(os.path.dirname(stream), exist_ok=True)
        synthesize_updates(g, UPDATE_EVENTS, seed=11).to_jsonl(stream)
    jobs = {name: dist_args(flags) for name, flags in DIST_SYNC}
    jobs["coordination"] = dist_coordination_job
    jobs["sgd"] = functools.partial(dist_sgd_job, argv=dist_args([]))
    jobs.update({f"fault_{f}": functools.partial(
        dist_fault_job, argv=dist_args([]), fault=f) for f in DIST_FAULTS})
    jobs.update({name: dist_args(["--fullgraph", "--refresh-frac", "0",
                                  *flags]) for name, flags in DIST_ASYNC})
    jobs["async_stream"] = dist_args(
        ["--fullgraph", "--staleness", "1", "--update-stream", stream,
         "--updates-per-epoch", str(DIST_STREAM_PER_EPOCH)],
        epochs=DIST_STREAM_EPOCHS)
    t0 = time.perf_counter()
    out = dict(zip(jobs, train_gnn.run_world(
        list(jobs.values()), world=DIST_WORLD, device="cuda",
        timeout_s=900)))
    print(f"   one world of {DIST_WORLD} ranks, {len(jobs)} jobs: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # K1 and K1ᵀ once a layer an epoch each: at 256 and at 41 columns
    want_k1_fwd = "gather_scale_segment_sum"
    want_k1 = {"gather_scale_segment_sum": 2, "gather_scale_segment_sum_t": 2}
    for name, res in out.items():
        if name in ("coordination", "sgd") or name.startswith("fault_"):
            continue
        summary = _dist_summary(res)
        epochs = len(res["losses"])
        launches = [r["launches"] for r in res["ranks"]]
        by_width = [r["launches_by_width"] for r in res["ranks"]]
        summary["launches_per_rank"] = launches
        summary["launches_per_rank_by_width"] = by_width
        summary["ranks_bitwise_equal"] = _dist_ranks_bitwise(res)
        if res["mode"] == "fullgraph":
            summary["stats"] = res["stats"]
            summary["accuracy"] = res["accuracy"]
            summary["ghost_digests_equal"] = len(
                {r["ghost_digest"] for r in res["ranks"]}) == 1
        print(f"   {name}: " + json.dumps(summary), flush=True)
        results[f"dist.{name}"] = summary
        require(bool(np.isfinite(res["losses"]).all()),
                f"{name}: finite losses")
        require(summary["ranks_bitwise_equal"],
                f"{name}: every rank's parameters bitwise equal")
        for r, (counts, widths) in enumerate(zip(launches, by_width)):
            want = {k: v * epochs for k, v in want_k1.items()}
            # rank 0 of --fullgraph: one forward more, the accuracy
            acc = int(res["mode"] == "fullgraph" and r == 0)
            want["gather_scale_segment_sum"] += 2 * acc
            require(counts == want, f"{name} rank {r}: launches {counts}, "
                    f"by design {want} (K6 none, nothing else)")
            want_w = {k: dict.fromkeys((HIDDEN, CLASSES), epochs + (
                acc if k == want_k1_fwd else 0)) for k in want_k1}
            require(widths == want_w, f"{name} rank {r}: K1 launches by "
                    f"width {widths}, by design {want_w}")
        if res["mode"] == "fullgraph":
            require(summary["ghost_digests_equal"],
                    f"{name}: every rank's ghost planes bitwise equal")
    for layout in ("pull", "push"):
        results[f"launches.dist.{layout}"] = out[layout]["ranks"][1][
            "launches_by_width"]
    # (a) pull against phase 6's single-card GCN (same graph and initial
    # parameters), then the other modes against pull: the first 4 losses
    # within the reference's 1e-4, the parameters after 10 AdamW epochs
    # within DIST_ADAMW_PARAM_TOL, which both faults must exceed; beside
    # them float32's own error (phase 6's run and pull against float64),
    # and after 10 SGD steps every mode within 1e-5 of the single card
    pull = out["pull"]
    adamw = {}                       # name: (first 4 losses, parameters)
    if "gcn" in TRAINED and "train.gcn" in results:
        one = results["train.gcn"]["losses"]
        ref = _params_np(TRAINED["gcn"][0])
        adamw["pull"] = (max(abs(a - b) for a, b in zip(pull["losses"][:4],
                                                        one[:4])),
                         _dist_params_diff(pull["params"], ref))
        results["dist.pull"].update(vs_single_card_early=adamw["pull"][0],
                                    vs_single_card_params=adamw["pull"][1])
        t0 = time.perf_counter()
        exact = _single_card(torch, TRAINED["gcn"][1], "adamw",
                             float64=True)
        floor = {"single_card_vs_float64": _dist_params_diff(ref, exact),
                 "pull_vs_float64": _dist_params_diff(pull["params"], exact),
                 "float64_s": time.perf_counter() - t0}
        results["dist.float32_floor"] = floor
        print("   float32's own error, parameters after 10 AdamW epochs: "
              + json.dumps(floor), flush=True)
    else:
        failures.append("14: phase 6's GCN is missing, pull not held to it")
    for name in ("push", "stale", "hysync", "async_s0"):
        res = out[name]
        adamw[name] = (max(abs(a - b) for a, b in zip(res["losses"][:4],
                                                      pull["losses"][:4])),
                       _dist_params_diff(res["params"], pull["params"]))
        results[f"dist.{name}"].update(vs_pull_early=adamw[name][0],
                                       vs_pull_params=adamw[name][1])
    faults = {f: _dist_params_diff(out[f"fault_{f}"]["ranks"][0]["params"],
                                   pull["params"]) for f in DIST_FAULTS}
    results["dist.faults_vs_pull"] = faults
    print("   AdamW, 10 epochs (pull vs phase 6's GCN, the others vs pull; "
          "first 4 losses, parameters): " + json.dumps(adamw), flush=True)
    print("   pull with a fault, parameters vs pull: " + json.dumps(faults),
          flush=True)
    for name, (early, pdiff) in adamw.items():
        require(early <= DIST_LOSS_TOL and pdiff <= DIST_ADAMW_PARAM_TOL,
                f"{name}: losses 1-4 within {DIST_LOSS_TOL} and parameters "
                f"within {DIST_ADAMW_PARAM_TOL} ({early:.3e}, {pdiff:.3e})")
    for what in ("single_card_vs_float64", "pull_vs_float64"):
        d = results.get("dist.float32_floor", {}).get(what, 0.0)
        require(d <= DIST_ADAMW_PARAM_TOL, f"{what}: {d:.3e} within "
                f"{DIST_ADAMW_PARAM_TOL}")
    for f, d in faults.items():
        require(d > DIST_ADAMW_PARAM_TOL, f"the AdamW bound "
                f"{DIST_ADAMW_PARAM_TOL} catches the fault {f} ({d:.3e})")
    sgd_ref = _single_card(torch, g, "sgd")
    sgd = {}
    for mode in DIST_SGD_MODES:
        per_rank = [r[mode] for r in out["sgd"]["ranks"]]
        sgd[mode] = _dist_params_diff(per_rank[0], sgd_ref)
        require(all(_dist_params_diff(p, per_rank[0]) == 0.0
                    for p in per_rank), f"SGD {mode}: ranks bitwise equal")
    results["dist.sgd_vs_single_card"] = sgd
    print("   SGD, 10 steps, parameters vs the single card: "
          + json.dumps(sgd), flush=True)
    require(max(sgd.values()) <= DIST_SGD_TOL,
            f"every mode within 1e-5 of the single card under SGD: {sgd}")
    require(_dist_params_diff(out["pull_again"]["params"], pull["params"])
            == 0.0 and out["pull_again"]["losses"] == pull["losses"],
            "two pull runs bitwise equal")
    # (c) the coordinators
    coord = [r["max_diff"] for r in out["coordination"]["ranks"]]
    results["dist.coordination"] = {"max_diff_per_rank": coord}
    print(f"   parameter server vs all-reduce: {coord}", flush=True)
    require(max(coord) <= 1e-5, "PS within 1e-5 of all-reduce")
    # (d) the asynchronous trainer's bytes and the int8 run
    b = [out[f"async_s{s}"]["stats"]["bytes_per_step"] for s in (0, 1, 4)]
    b8 = out["async_s1_int8"]["stats"]["bytes_per_step"]
    l32 = out["async_s1"]["losses"][-1]
    l8 = out["async_s1_int8"]["losses"][-1]
    results["dist.async_bytes"] = {"s0": b[0], "s1": b[1], "s4": b[2],
                                   "s1_int8": b8, "int8_ratio": b8 / b[1],
                                   "int8_loss_rel": abs(l8 - l32) / l32}
    print("   async bytes/step: " + json.dumps(results["dist.async_bytes"]),
          flush=True)
    require(b[0] > b[1] > b[2], f"bytes/step fall with S: {b}")
    require(b8 <= 0.35 * b[1], "int8 moves <= 0.35 of fp32's bytes")
    require(abs(l8 - l32) <= 0.05 * abs(l32), "int8 final loss within 5 % "
            "of fp32's")
    st = out["async_stream"]
    folds = st["folds"]
    results["dist.async_stream"].update(
        folds=len(folds), events=sum(f["events"] for f in folds),
        invalidated_rows=sum(f["invalidated_rows"] for f in folds),
        fold_s=[f["seconds"] for f in folds])
    require(st["update_seq"] == UPDATE_EVENTS and sum(
        f["events"] for f in folds) == UPDATE_EVENTS
        and all(f["invalidated_rows"] > 0 for f in folds),
        "the stream folded in full, ghost rows invalidated at each fold")
    # (e) K1 / K1ᵀ at the distributed shapes
    _dist_k1_cases(torch, g, results)


def kernels_line(results) -> dict:
    """One row per kernel: its times from phase 2, 5 or 8, its launches
    from the phase that drives the path through it (phases 6 and 7 train
    through K1-K6 and K3's VJP, phases 9 and 10 serve through K7 and K8;
    the float32 routes of K7 and K8 run in the float32 prefills of phases
    9 and 10).  K3's row is the served inner block, with GAT's whole graph
    at 4 x 64 and 4 x 10 beside it; its VJP's row is 4 x 64, with 4 x 10
    beside it.  K1's row is the served inner block, with the whole graph
    at 602, 256 and 41 beside it; its transpose's row is GCN's 256, with
    41 and the GAT VJP's source pass (4 x 64, 4 x 10, without and with
    the column) beside it."""
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
            ("gat_attention_backward", "gat_backward", "gat_fused.cu",
             "src/repro/kernels/gat_fused.py:217", "launches.train.gat"),
            ("gather_scale_segment_sum_q", "gather_scale_segment_sum_q",
             "segment_sum.cu", "src/repro/kernels/segment_sum.py:580",
             "launches.minibatch.int8"),
            ("gather_rows", "gather_rows", "segment_sum.cu",
             "src/repro/kernels/segment_sum.py:221", "launches.train.gin"),
            ("edge_dot", "edge_dot", "segment_sum.cu",
             "src/repro/kernels/segment_sum.py:411", "launches.train.gat"),
            ("flash_attention", "flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:90",
             f"launches.lm.{PHI3}"),
            ("flash_attention_fp32", "flash_attention_fp32",
             "flash_attention.cu", "src/repro/kernels/flash_attention.py:90",
             f"launches.lm_fp32.{PHI3}"),
            ("ssd_chunk_state", "ssd_chunk_state", "ssd_chunk.cu",
             "src/repro/kernels/ssd_chunk.py:55", f"launches.lm.{MAMBA2}"),
            ("ssd_chunk_state_fp32", "ssd_chunk_state_fp32", "ssd_chunk.cu",
             "src/repro/kernels/ssd_chunk.py:55",
             f"launches.lm_fp32.{MAMBA2}"),
            ("ssd_chunk_state_bf16_cuda_core",
             "ssd_chunk_state_bf16_cuda_core", "ssd_chunk.cu",
             "src/repro/kernels/ssd_chunk.py:55", f"launches.lm.{MAMBA2}")]
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
        if name == "ssd_chunk_state":
            rn = results["ssd_chunk_state.n64"]
            rows[-1]["at_zamba2_n64"] = {
                k: rn[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
        # K3 and its VJP over GAT's whole graph at its two layers' shapes
        wide = f"{GAT_HEADS}x{HIDDEN // GAT_HEADS}"
        narrow = f"{GAT_HEADS}x{GAT_CLASSES // GAT_HEADS}"
        extra = {"gat_attention": {f"at_{w}": f"gat_attention.full.{w}"
                                   for w in (wide, narrow)},
                 "gat_attention_backward": {f"at_{narrow}":
                                            f"gat_backward.{narrow}"},
                 # K1 over the whole graph at each trainer's width, and
                 # its transposes (GCN's, the GAT VJP's source pass)
                 "gather_scale_segment_sum": {
                     f"at_full_{F}": f"k1.full.{F}"
                     for F in (FEAT, HIDDEN, CLASSES)},
                 "gather_scale_segment_sum_t": {
                     "at_41": f"k1_transpose.{CLASSES}",
                     **{f"at_{w}": f"k1_transpose.{w}"
                        for w in (wide, narrow)},
                     **{f"at_{w}_col": f"k1_transpose_col.{w}"
                        for w in (wide, narrow)}}}
        for label, key_ in extra.get(name, {}).items():
            rows[-1][label] = {k: results[key_][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms") if k in results[key_]}
        # phase 14: K1 and its transpose at the distributed shapes (rank
        # 0 of 4), with rank 1's launches at that width in the 10 pull
        # (push) epochs, as the wrapper counted them
        if name in ("gather_scale_segment_sum", "gather_scale_segment_sum_t"):
            pre = "k1" if name == "gather_scale_segment_sum" else \
                "k1_transpose"
            for layout in ("pull", "push"):
                for F in (HIDDEN, CLASSES):
                    r = results.get(f"{pre}.dist.{layout}.{F}")
                    if r is None:
                        continue
                    rows[-1][f"at_dist_{layout}_{F}"] = dict(
                        {k: r[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")},
                        launches_per_rank=results.get(
                            f"launches.dist.{layout}", {}).get(
                                name, {}).get(F, 0))
        if name == "flash_attention":
            # phase 13's configs: the case at each prefill shape (phase 8)
            # and its launches in that config's prefill (phase 13)
            for arch in ZOO:
                r = results[f"flash_attention.{arch}"]
                rows[-1][f"at_{arch}"] = dict(
                    {k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by",
                                       "library_ms")},
                    launches=results[f"launches.lm.{arch}"].get(name, 0))
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
    phase_build(torch, results)
    t0 = time.perf_counter()
    g = reddit_graph()
    blocks, x_np = sampled_blocks(g, FANOUTS)
    print(f"reddit-width graph: {g.num_nodes} nodes, {g.num_edges} edges "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    phase_kernels(torch, blocks, x_np, results)
    phase_serve(torch, results)
    phase_cpu_parity(torch, blocks, x_np)
    phase_profile(torch, blocks, x_np, results)
    phase_gin_gat(torch, results)
    g_gat = reddit_graph(GAT_CLASSES)
    phase_train_kernels(torch, g, g_gat, results)
    del blocks, x_np
    phase_fullbatch(torch, results)
    phase_minibatch(torch, results)
    phase_reorder_kernels(torch, g, g_gat, results)
    del g_gat
    phase_reorder_train(torch, results)
    phase_reorder_serve(torch, results)
    phase_update_stream(torch, g, results)
    phase_samplers(torch, results)
    phase_datasets(torch, results)
    phase_replicas(torch, results)
    phase_autoscale(torch, results)
    phase_hot_swap(torch, results)
    phase_replica_updates(torch, g, results)
    phase_lm_kernels(torch, results)
    phase_phi3(torch, results)
    phase_mamba2(torch, results)
    for arch in ZOO:
        phase(f"13. serve {arch} at full width, bf16")(zoo_phase)(
            torch, arch, results)
        torch.cuda.empty_cache()
    phase_distributed(torch, g, results)
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
