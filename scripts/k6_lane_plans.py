#!/usr/bin/env python3
"""Time K6 (``edge_dot`` of ``src/repro_torch/kernels/csrc/segment_sum.cu``,
the edge dot over the dst-grouped layout) under candidate lane plans, on
the card, at the shapes ``chip_smoke.py`` phase 5 checks it: 1 x 256 over
the 41-class Reddit-width graph (the reference's single-head dcoef) and 4
x 64 and 4 x 10 over the 40-class one (GAT's heads).  Candidates: the
plans ``segment_sum.lane_plan`` gives at 4, 8, 16 and 32 floats a lane;
each under every count of elements of ``a`` a lane may hold in flight
given by ``--words`` (the source's ``ED_WORDS``, which fixes the edges
in flight of each instance: the built library takes the source's, the
others are built from edited copies of the source under
``build/k6_words_<n>/``).  The plan ``segment_sum.edge_dot_plan`` picks
is marked.  Every plan's output is held against the plain version (1e-4
of the largest value).

    python3 scripts/k6_lane_plans.py [--words 24 32 48]   # from a checkout

Prints one JSON object: per case, the median ms (CUDA events, L2
flushed, as ``chip_smoke.median_ms``) of each plan and words.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def libraries(words):
    """{ED_WORDS: the loaded segment_sum library built with it}; the
    built library has the source's (the wrapper's, a test holds them
    equal)."""
    from repro_torch.kernels import build
    from repro_torch.kernels import segment_sum as ss
    own = ss.ED_WORDS
    text = (build.CSRC / "segment_sum.cu").read_text()
    libs = {own: build.library("segment_sum")}
    procs = {}
    for w in words:
        if w == own:
            continue
        d = os.path.join(ROOT, "build", f"k6_words_{w}")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        src = os.path.join(d, "segment_sum.cu")
        with open(src, "w", encoding="utf-8") as f:
            f.write(text.replace(f"constexpr int ED_WORDS = {own};",
                                 f"constexpr int ED_WORDS = {w};"))
        so = os.path.join(d, "libsegment_sum.so")
        procs[w] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for w, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for ED_WORDS {w}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.edge_dot.argtypes = build.SIGNATURES["segment_sum"]["edge_dot"]
        lib.edge_dot.restype = ctypes.c_int
        libs[w] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--words", type=int, nargs="+", default=[24, 32, 48])
    args = ap.parse_args()
    import torch

    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.kernels import build
    from repro_torch.kernels import segment_sum as ss
    print(cs.nvidia_smi_line(), flush=True)
    libs = libraries(args.words)
    c = cs.Checker(torch, seed=22)
    graphs = {cs.CLASSES: DeviceGraph.from_graph(cs.reddit_graph(), c.dev),
              cs.GAT_CLASSES: DeviceGraph.from_graph(
                  cs.reddit_graph(cs.GAT_CLASSES), c.dev)}
    out = {"card": cs.nvidia_smi_line(), "cases": {}}
    for heads, hd, classes in ((1, cs.HIDDEN, cs.CLASSES),
                               (cs.GAT_HEADS, cs.HIDDEN // cs.GAT_HEADS,
                                cs.GAT_CLASSES),
                               (cs.GAT_HEADS, cs.GAT_CLASSES // cs.GAT_HEADS,
                                cs.GAT_CLASSES)):
        gr = graphs[classes]
        N, F = gr.num_dst, heads * hd
        a, b = c.randn(N, F), c.randn(N, F)
        ref = ss.edge_dot_plain(a, b, gr.edge_src, gr.order, gr.row_ptr,
                                heads)
        scale = ref.abs().max().item()
        picked = ss.edge_dot_plan(heads, hd, 16)
        plans = {}
        for fpl in (4, 8, 16, 32):
            try:
                p = ss.lane_plan(heads, hd, 16, fpl, max_vpl=ss.ED_MAX_VPL)
            except ValueError:
                continue
            plans[tuple(sorted(p.items()))] = p
        rows = []
        for words, lib in sorted(libs.items()):
            for p in plans.values():
                o = torch.zeros((gr.edge_src.numel(), heads), device=c.dev)

                def call():
                    build.check(lib.edge_dot(
                        a.data_ptr(), b.data_ptr(), gr.edge_src.data_ptr(),
                        gr.order.data_ptr(), gr.row_ptr.data_ptr(),
                        o.data_ptr(), N, F, heads, p["vec"], p["hpg"],
                        p["lph"], p["vpl"], 1, p["group"], ss._stream()),
                        "edge_dot")
                call()
                torch.cuda.synchronize()
                err = (o - ref).abs().max().item()
                cs.require(err <= 1e-4 * scale, f"{heads} x {hd} {p}: err "
                           f"{err} of {scale}")
                ne = ss.gss_ne(p["vpl"] * p["vec"], words)
                row = {"words": words, "ne": ne, "ms": cs.median_ms(
                    torch, call, c.flush), **p,
                    "picked": words == ss.ED_WORDS
                    and all(picked[k] == p[k] for k in p)}
                print("   " + json.dumps(row), flush=True)
                rows.append(row)
        out["cases"][f"{heads}x{hd}"] = rows
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
