"""Decode ms a step of the serving launcher, one source tree against
another, on one card: ``repro_torch.launch.serve.run`` (the loop
``serve.main`` runs: the prompt folded into decode steps, then ``--gen``
greedy steps against a pre-sized cache) at full width in bf16, for each
architecture, each run in a child process of its own with ``PYTHONPATH``
set to its tree's ``src``.  The runs go A B B A, ``--rounds`` times over,
so that a drift of the host falls on both trees alike.  Each run gives the
ms of a generated step (``1e3 * batch / decode_tok_s``) and of a prompt
step; a summary gives each (architecture, tree) its median and range.

    python3 scripts/decode_ab.py --trees OTHER_CHECKOUT . --rounds 3

Prints one JSON line a run, then one a (architecture, tree), and writes
them all to ``chiprun_out/decode_ab.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = ("import json, sys\n"
         "from repro_torch.launch import serve\n"
         "r = serve.run(sys.argv[1:])\n"
         "a = r['args']\n"
         "print('RESULT', json.dumps({\n"
         "    'decode_ms': 1e3 * a.batch / r['decode_tok_s'],\n"
         "    'prompt_ms': 1e3 * a.batch / r['prefill_tok_s'],\n"
         "    'first_tokens': r['tokens'][0, :8].tolist()}))\n")


def one(tree: str, arch: str, args) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(tree, "src"))
    p = subprocess.run(
        [sys.executable, "-c", CHILD, "--arch", arch, "--batch",
         str(args.batch), "--prompt-len", str(args.prompt_len), "--gen",
         str(args.gen)], capture_output=True, text=True, env=env, cwd=tree,
        timeout=args.timeout)
    line = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    if p.returncode or not line:
        raise RuntimeError(f"{arch} in {tree}: rc {p.returncode}: "
                           f"{p.stdout[-800:]} {p.stderr[-800:]}")
    return json.loads(line[0][len("RESULT "):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs=2, required=True,
                    help="two checkouts of the repo, A and B")
    ap.add_argument("--archs", nargs="+",
                    default=["phi3-mini-3.8b", "mamba2-780m"])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=128)
    ap.add_argument("--timeout", type=float, default=180)
    args = ap.parse_args(argv)
    import numpy as np

    trees = [os.path.abspath(t) for t in args.trees]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    runs, summary = [], []
    for arch in args.archs:
        for _ in range(args.rounds):
            for tree in (trees[0], trees[1], trees[1], trees[0]):
                r = dict(one(tree, arch, args), arch=arch, tree=tree)
                runs.append(r)
                print(json.dumps(r), flush=True)
        for tree in trees:
            mine = [r for r in runs if r["arch"] == arch and r["tree"] == tree]
            d = [r["decode_ms"] for r in mine]
            s = {"arch": arch, "tree": tree, "runs": len(d),
                 "decode_ms_median": float(np.median(d)),
                 "decode_ms_range": [min(d), max(d)],
                 "prompt_ms_median": float(np.median(
                     [r["prompt_ms"] for r in mine]))}
            summary.append(s)
            print(json.dumps(s), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "decode_ab.json"), "w",
              encoding="utf-8") as f:
        json.dump({"card": smi, "args": vars(args), "runs": runs,
                   "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
