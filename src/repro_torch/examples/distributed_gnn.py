"""Distributed GNN training demo (the paper's core scenario; the
reference's ``examples/distributed_gnn.py`` on the port's launcher),
driving ``repro_torch.launch.train_gnn`` across the system families in
``repro_torch.distributed`` and ``repro_torch.core.propagation``:
synchronous full-graph (pull mode, selectable partitioner), epoch-level
stale snapshots (DistGNN), staleness-bounded asynchronous full-graph
(``--fullgraph``: versioned ghost buffers + refresh budget — once raw
fp32, once with the int8 wire codec compressing every ghost refresh
~4x), and partition-parallel mini-batch (halo-cached remote fetches, an
all-reduced step).  Every run spawns its ranks (gloo); the runs of one
world size share one spawned world (``train_gnn.run_world``).

  PYTHONPATH=src python -m repro_torch.examples.distributed_gnn \\
      [--device cpu]
"""
from __future__ import annotations

import argparse
import itertools

from repro_torch.launch import train_gnn

RUNS = [
    ["--devices", "8", "--partitioner", "hash", "--mode", "pull",
     "--epochs", "15"],
    ["--devices", "8", "--partitioner", "ldg", "--mode", "pull",
     "--epochs", "15"],
    ["--devices", "8", "--partitioner", "ldg", "--mode", "stale",
     "--staleness", "4", "--epochs", "15"],
    ["--fullgraph", "--devices", "4", "--partitioner", "ldg",
     "--staleness", "2", "--refresh-frac", "0.05", "--epochs", "15"],
    ["--fullgraph", "--devices", "4", "--partitioner", "ldg",
     "--staleness", "2", "--refresh-frac", "0.05", "--epochs", "15",
     "--wire-codec", "int8"],
    ["--minibatch", "--devices", "4", "--partitioner", "ldg",
     "--cache", "degree", "--arch", "sage", "--epochs", "2"],
]


def _world(run) -> int:
    return int(run[run.index("--devices") + 1])


def run(runs, device: str) -> list:
    """Each argv of ``runs`` with ``--device device`` through the
    launcher: consecutive runs of one world size in one spawned world.
    Returns their summaries, in order."""
    out = []
    for world, group in itertools.groupby(runs, key=_world):
        group = [list(r) + ["--device", device] for r in group]
        print("=" * 70)
        print(f"one world of {world} ranks, {len(group)} runs in turn:")
        for r in group:
            print("  train_gnn", " ".join(r))
        out += train_gnn.run_world(group, world=world, device=device)
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises when CUDA is "
                         "missing)")
    args = ap.parse_args(argv)
    out = run(RUNS, args.device)
    print("distributed_gnn OK")
    return out


if __name__ == "__main__":
    main()
