#!/usr/bin/env python3
"""Run the GNN paths of ``chip_smoke.py`` end to end from this checkout
and from another one, in turns on one card: other, this, this, other.
Each turn is a process of its own that imports that checkout's code (and
builds its kernels), so two commits compare end to end on the same card.
The paths, at Reddit's widths (232 965 nodes, 602 -> 256 -> 41):

- ``gcn``, ``sage``, ``gat``: full-batch training, 10 epochs through
  ``repro_torch.launch.train_gnn`` (``chip_smoke.py``'s phase 6; GAT ->
  40 classes); the median epoch of epochs 2-10;
- ``minibatch.fp32``, ``minibatch.int8``: one epoch of mini-batch SAGE,
  batch 1024, degree cache, fp32 rows or int8 rows into K4 (phase 7);
  the median and p90 step;
- ``serve``: SAGE serving 128 requests through
  ``repro_torch.launch.serve_gnn`` with telemetry on (phase 3);
  throughput (with the embedding cache, and without it), p50 and p99.

    python3 scripts/paths_in_turns.py --other DIR [--paths P ...]
        [--time-k1]

With ``--time-k1`` every call of K1's and K4's CUDA wrappers is timed:
the host seconds inside the wrapper and the device time between CUDA
events recorded around it, summed per path (``k1_k4``).  A checkout's
first turn builds its kernels inside its first call, which these sums
then hold.

Prints one JSON object a turn as it ends, then one with every turn:
the checkout, the card, and per path its numbers and launch counts.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATHS = ("gcn", "sage", "gat", "minibatch.fp32", "minibatch.int8", "serve")


def timed_k1(torch):
    """Wrap K1's and K4's CUDA wrappers to sum their host seconds and
    their device time (CUDA events around each call); returns a function
    that restores them and gives the totals (after a synchronise)."""
    from repro_torch.kernels import segment_sum as ss
    names = ("gather_scale_segment_sum_cuda",
             "gather_scale_segment_sum_q_cuda")
    saved = {n: getattr(ss, n) for n in names}
    host, events = [0.0], []

    def wrap(fn):
        def call(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            out = fn(*args, **kw)
            end.record()
            host[0] += time.perf_counter() - t0
            events.append((start, end))
            return out
        return call
    for n in names:
        setattr(ss, n, wrap(saved[n]))

    def done() -> dict:
        for n in names:
            setattr(ss, n, saved[n])
        torch.cuda.synchronize()
        return {"calls": len(events), "host_ms": host[0] * 1e3,
                "device_ms": sum(a.elapsed_time(b) for a, b in events)}
    return done


def run_path(cs, path: str, time_k1: bool = False) -> dict:
    """One path from the imported checkout's code (``cs`` its
    ``chip_smoke``), its launches counted."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve_gnn, train_gnn
    ops.reset_launch_counts()
    k1 = timed_k1(torch) if time_k1 else None
    if path in ("gcn", "sage", "gat"):
        classes = cs.GAT_CLASSES if path == "gat" else cs.CLASSES
        res = train_gnn.main(cs.train_args(path, classes, [
            "--epochs", str(cs.TRAIN_EPOCHS)]))
        out = {"median_epoch_ms": float(np.median(res["epoch_s"][1:])) * 1e3}
    elif path.startswith("minibatch."):
        codec = path.split(".")[1]
        res = train_gnn.main(cs.train_args("sage", cs.CLASSES, [
            "--minibatch", "--batch", str(cs.MB_BATCH), "--epochs", "1",
            "--cache", "degree", "--wire-codec", codec,
            *(["--use-kernel"] if codec == "int8" else [])]))
        out = {"steps": res["steps"],
               "median_step_ms": float(np.median(res["step_s"])) * 1e3,
               "p90_step_ms": float(np.percentile(res["step_s"], 90)) * 1e3}
    else:
        from repro_torch.core import telemetry
        telemetry.set_enabled(True)
        telemetry.get_registry().reset()
        res = serve_gnn.main([
            "--arch", "sage", "--nodes", str(cs.NODES), "--classes",
            str(cs.CLASSES), "--feat-dim", str(cs.FEAT), "--hidden",
            str(cs.HIDDEN), "--fanouts", *map(str, cs.FANOUTS),
            "--requests", "128", "--device", "cuda"])
        telemetry.set_enabled(False)
        out = {k: res[k] for k in ("served", "throughput_rps", "p50_ms",
                                   "p99_ms")}
        out["no_cache_rps"] = res["no_cache"]["throughput_rps"]
    torch.cuda.synchronize()
    out["launches"] = {k: v for k, v in ops.launch_counts().items() if v}
    if k1 is not None:
        out["k1_k4"] = k1()
    return out


def turn(root: str, paths, time_k1: bool = False) -> dict:
    """One turn in this process: each path from ``root``'s code."""
    sys.path.insert(0, root)
    import chip_smoke as cs  # noqa: E402  (puts root's src/ on the path)
    out = {"root": root, "card": cs.nvidia_smi_line()}
    for path in paths:
        out[path] = run_path(cs, path, time_k1)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--paths", nargs="+", choices=PATHS, default=PATHS)
    ap.add_argument("--time-k1", action="store_true",
                    help="time every K1 and K4 call (host and device)")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.turn, args.paths, args.time_k1)))
        return 0
    if not args.other:
        ap.error("--other DIR is required")
    other = os.path.abspath(args.other)
    turns = []
    for root in (other, ROOT, ROOT, other):
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--turn", root, "--paths", *args.paths,
                               *(["--time-k1"] if args.time_k1 else [])],
                              capture_output=True, text=True)
        if done.returncode != 0:
            sys.stderr.write(done.stdout[-4000:] + done.stderr[-4000:])
            return done.returncode
        turns.append(json.loads(done.stdout.strip().splitlines()[-1]))
        print(json.dumps(turns[-1]), flush=True)
    print(json.dumps({"turns": turns}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
