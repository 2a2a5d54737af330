"""Per-layer recompute in the transformer trainer, off against on, on one
card: the peak device memory, the ms of a step and the kernel launches
of a step of ``model.make_train_step(cfg, opt, remat=...)`` at
``chip_smoke.py`` phase 20's training shapes (20(b)'s Qwen2.5-14B 4-layer
cut, B 4 x S 1024; 20(c)'s Mamba2-780m, B 2 x S 1024; bf16, AdamW, the
launcher's config and batches).  The launcher trains with ``remat=False``
as the reference's does; the dry run's train step and ``make_train_step``'s
default take ``remat=True``.  Each setting runs in a process of its own,
so one's peak does not carry into the other's; the step time is the
median of the steps after the first, each ending in a synchronise.

    python3 scripts/remat_peak.py        # on a machine with the card

Prints one JSON line a (model, setting) and writes them all to
``chiprun_out/remat_peak.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: (label, launcher flags): chip_smoke.py's TRAIN_RUNS, 4 steps each
CASES = (("qwen2.5-14b 4 layers, B 4 x S 1024",
          ["--arch", "qwen2.5-14b", "--layers", "4", "--batch", "4",
           "--seq", "1024", "--steps", "4", "--lr", "3e-4", "--warmup", "2"]),
         ("mamba2-780m 48 layers, B 2 x S 1024",
          ["--arch", "mamba2-780m", "--batch", "2", "--seq", "1024",
           "--steps", "4", "--lr", "3e-4", "--warmup", "2"]))


def one(argv, remat: bool) -> dict:
    import time

    import numpy as np
    import torch

    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.kernels import ops
    from repro_torch.launch import train as T
    from repro_torch.models.transformer import model as M
    from repro_torch.optim import AdamW, cosine_schedule
    args = T.parse_args(argv)
    cfg = T.config(args)
    dev = torch.device("cuda")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           max_seq=args.seq, device=dev)
    opt = AdamW(M.trainable(params), lr=cosine_schedule(
        args.lr, args.warmup, args.steps), weight_decay=0.01)
    step = M.make_train_step(cfg, opt, remat=remat)
    it = SyntheticLMDataset(cfg.vocab_size, args.seq, seed=0).batches(
        args.batch)
    torch.cuda.reset_peak_memory_stats()
    secs, losses, launches = [], [], []
    for _ in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        m = step(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        launches.append({k: n for k, n in ops.launch_counts().items() if n})
    return {"remat": remat, "peak_gib": torch.cuda.max_memory_allocated()
            / 2**30, "ms_per_step": float(np.median(secs[1:])) * 1e3,
            "losses": losses, "launches_per_step": launches[-1]}


def main() -> int:
    if len(sys.argv) == 4:          # a child: label index, remat flag
        label, argv = CASES[int(sys.argv[1])]
        r = one(argv, sys.argv[2] == "1")
        r["case"] = label
        print("RESULT " + json.dumps(r), flush=True)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    rows = []
    for i in range(len(CASES)):
        for remat in (0, 1):
            p = subprocess.run([sys.executable, __file__, str(i),
                                str(remat), "child"], capture_output=True,
                               text=True, cwd=ROOT)
            got = [line[7:] for line in p.stdout.splitlines()
                   if line.startswith("RESULT ")]
            if p.returncode or not got:
                print(p.stdout[-2000:] + p.stderr[-2000:], flush=True)
                return 1
            r = json.loads(got[0])
            r["card"] = smi
            rows.append(r)
            print(json.dumps(r), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "remat_peak.json"), "w",
              encoding="utf-8") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
