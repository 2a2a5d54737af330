#!/usr/bin/env python3
"""Time K1 (``gss_forward``) and K4 (``gssq_forward``) of
``src/repro_torch/kernels/csrc/segment_sum.cu`` under each candidate lane
plan, on the card, at the shapes ``chip_smoke.py`` checks them: K1 over
the whole Reddit-width graph at 602, 256 and 41 wide (SAGE's and GCN's
forwards), over its src layout at 256 and 41 (GCN's transposes) and at 4
x 64 and 4 x 10 with and without a column (GAT's VJP source pass), on
the served blocks (602 inner, 256 outer), and K4 on the int8 rows of a
batch-1024 block.  Candidates: 8 or 16 floats a lane and, with one head,
every count of lanes a head and a row cut into 1-4 slices; every built
count of edges in flight.  The plan
``segment_sum.gss_plan`` picks is marked.  Every plan's output is held
against the plain version (1e-4 of the largest value) and, bit for bit,
against the picked plan's: the arithmetic of each element is the same
under every plan.

    python3 scripts/k1_lane_plans.py [--parent DIR]   # from a checkout

With ``--parent DIR`` (another checkout, such as ``git archive`` of an
earlier commit unpacked under ``build/``), its ``segment_sum.cu`` is
built too and its K1 and K4 (the one-block-a-row kernels, whose C
signatures end in ``num_dst, F, heads, stream`` and ``num_dst, F,
stream``) are held bitwise against the picked plan at every case and
timed in turns (parent, picked, picked, parent).

Prints one JSON object: per case, the median ms (CUDA events, L2
flushed, as ``chip_smoke.median_ms``) of each plan, and the parent's.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def candidates(heads, hd, align, num_dst, quantized):
    """The picked plan first, then every other built plan: 8 or 16
    floats a lane (as lane_plan searches them) and, with one head, every
    count of lanes a head and a row cut into 1-4 slices; each with every
    built count of edges in flight."""
    from repro_torch.kernels import segment_sum as ss
    picked = ss.gss_plan(heads, hd, align, num_dst, quantized=quantized)
    cores = [ss.gss_plan(heads, hd, align, wide, quantized=quantized)
             for wide in (0, ss.WIDE_DST)]
    vec = picked["vec"]
    nvh = hd // vec
    if heads == 1:
        for nsl in (1, 2, 3, 4):
            lph = 1
            while lph <= ss.WARP:
                vpl = -(-(-(-nvh // nsl)) // lph)
                if vpl <= ss.GSS_MAX_VPL:
                    cores.append({"vec": vec, "hpg": 1, "lph": lph,
                                  "vpl": vpl, "group": lph, "nsl": nsl})
                lph *= 2
    out = [picked]
    for core in cores:
        for ne in ss.GSS_NES:
            if not ss.gss_built(vec, core["vpl"], ne, quantized):
                continue
            plan = dict(core, ne=ne)
            if plan not in out:
                out.append(plan)
    return out


def parent_library(parent):
    """The parent's segment_sum.cu, built into build/ with the same
    flags, its K1 and K4 signatures set."""
    from repro_torch.kernels import build
    src = os.path.join(parent, "src/repro_torch/kernels/csrc/segment_sum.cu")
    out = os.path.join(ROOT, "build", "parent_segment_sum.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", out, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(out)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.gss_forward.argtypes = [P] * 8 + [I] * 3 + [P]
    lib.gssq_forward.argtypes = [P] * 8 + [I] * 2 + [P]
    lib.gss_forward.restype = lib.gssq_forward.restype = I
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another checkout whose K1 and K4 are "
                    "held bitwise against these and timed beside them")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_lane_plans: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.kernels import build
    from repro_torch.kernels import segment_sum as ss
    dev = torch.device("cuda")
    c = cs.Checker(torch, seed=7)
    g = cs.reddit_graph()
    dg = DeviceGraph.from_graph(g, dev, src_layout=True)
    dga = DeviceGraph.from_graph(cs.reddit_graph(cs.GAT_CLASSES), dev,
                                 src_layout=True)
    blocks, x_np = cs.sampled_blocks(g, cs.FANOUTS)
    g_in, g_out = (DeviceGraph.from_block(b, dev) for b in blocks)
    N = g.num_nodes
    src, dst = dg.edge_src, dg.edge_dst
    coef = (torch.rsqrt(dg.out_deg)[src.long()]
            * torch.rsqrt(dg.in_deg)[dst.long()])
    mask = dg.edge_mask.to(torch.float32)
    Ea = dga.edge_src.numel()
    emask = dga.edge_mask[:, None].to(torch.float32)
    alpha = torch.rand((Ea, cs.GAT_HEADS), generator=c.gen).to(dev) * emask
    dpre = c.randn(Ea, cs.GAT_HEADS) * emask
    # (label, h, idx, coef, order, row_ptr, num_out, col)
    k1_cases = [
        ("k1.full.602", c.randn(N, cs.FEAT), src, mask, dg.order,
         dg.row_ptr, N, None),
        ("k1.full.256", c.randn(N, cs.HIDDEN), src, coef, dg.order,
         dg.row_ptr, N, None),
        ("k1.full.41", c.randn(N, cs.CLASSES), src, coef, dg.order,
         dg.row_ptr, N, None),
        ("k1_transpose.256", c.randn(N, cs.HIDDEN), dst, coef,
         *dg.src_layout, N, None),
        ("k1_transpose.41", c.randn(N, cs.CLASSES), dst, coef,
         *dg.src_layout, N, None)]
    for F in (cs.HIDDEN, cs.GAT_CLASSES):
        w = f"4x{F // cs.GAT_HEADS}"
        rows = c.randn(N, F)
        k1_cases += [
            (f"k1_transpose.{w}", rows, dga.edge_dst, alpha,
             *dga.src_layout, N, None),
            (f"k1_transpose_col.{w}", rows, dga.edge_dst, alpha,
             *dga.src_layout, N, dpre)]
    k1_cases += [
        ("k1.served.inner", torch.from_numpy(x_np).to(dev), g_in.edge_src,
         g_in.edge_mask.to(torch.float32), g_in.order, g_in.row_ptr,
         g_in.num_dst, None),
        ("k1.served.outer", c.randn(g_out.num_src, cs.HIDDEN),
         g_out.edge_src, g_out.edge_mask.to(torch.float32), g_out.order,
         g_out.row_ptr, g_out.num_dst, None)]
    blk, q, mn, scale = cs.minibatch_block(torch, g, dev)
    k4_args = (q, mn, scale, blk.edge_src, blk.edge_mask.to(torch.float32),
               blk.order, blk.row_ptr, blk.num_dst)

    parent = parent_library(args.parent) if args.parent else None
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def parent_k1(h, idx, cf, order, row_ptr, D, col):
        heads = 1 if cf.dim() == 1 else cf.shape[1]
        out = torch.empty((D, h.shape[1]), device=dev)
        col_out = (torch.empty((D, heads), device=dev) if col is not None
                   else None)
        build.check(parent.gss_forward(
            h.data_ptr(), idx.data_ptr(), cf.data_ptr(),
            None if col is None else col.data_ptr(), order.data_ptr(),
            row_ptr.data_ptr(), out.data_ptr(),
            None if col is None else col_out.data_ptr(), D, h.shape[1],
            heads, stream()), "parent gss_forward")
        return out if col is None else (out, col_out)

    def parent_k4(q, mn, scale, idx, cf, order, row_ptr, D):
        out = torch.empty((D, q.shape[1]), device=dev)
        build.check(parent.gssq_forward(
            q.data_ptr(), mn.data_ptr(), scale.data_ptr(), idx.data_ptr(),
            cf.data_ptr(), order.data_ptr(), row_ptr.data_ptr(),
            out.data_ptr(), D, q.shape[1], stream()), "parent gssq_forward")
        return out

    cases = []
    for label, h, idx, cf, order, row_ptr, D, col in k1_cases:
        heads = 1 if cf.dim() == 1 else cf.shape[1]
        a = (h, idx, cf, order, row_ptr, D)
        fn = (lambda a=a, col=col: ss.gather_scale_segment_sum_cuda(
            *a, col=col))
        ref = ss.gather_scale_segment_sum_plain(*a, col=col)
        par = (lambda a=a, col=col: parent_k1(*a, col)) if parent else None
        cases.append((label, fn, ref, par, (heads, h.shape[1] // heads,
                                            ss._align(h), D, False)))
    vec = next(v for v in (4, 2, 1) if cs.FEAT % v == 0
               and q.data_ptr() % v == 0)
    cases.append(("k4", lambda: ss.gather_scale_segment_sum_q_cuda(*k4_args),
                  ss.gather_scale_segment_sum_q_plain(*k4_args),
                  (lambda: parent_k4(*k4_args)) if parent else None,
                  (1, cs.FEAT, 4 * vec, blk.num_dst, True)))

    def first(x):
        return x[0] if isinstance(x, tuple) else x

    chosen = ss.gss_plan
    out = {"card": cs.nvidia_smi_line()}
    try:
        for label, fn, ref, par, key in cases:
            heads, hd, align, D, quantized = key
            rows, want = [], None
            for plan in candidates(heads, hd, align, D, quantized):
                ss.gss_plan = lambda *a, p=plan, **k: p
                got = fn()
                torch.cuda.synchronize()
                for x, r in zip(got if isinstance(got, tuple) else (got,),
                                ref if isinstance(ref, tuple) else (ref,)):
                    err = (x - r).abs().max().item() if r.numel() else 0.0
                    cs.require(err <= 1e-4 * r.abs().max().item(),
                               f"{label} {plan}: error {err}")
                if want is None:
                    want = got
                cs.require(all(torch.equal(x, y) for x, y in zip(
                    got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,))),
                    f"{label} {plan}: not bitwise the picked plan's")
                rows.append({"plan": plan, "picked": not rows,
                             "ms": cs.median_ms(torch, fn, c.flush)})
            ss.gss_plan = chosen         # the next case's candidates
            res = {"plans": rows}
            if par is not None:
                old = par()
                torch.cuda.synchronize()
                res["bitwise_vs_parent"] = all(
                    torch.equal(x, y) for x, y in zip(
                        old if isinstance(old, tuple) else (old,),
                        want if isinstance(want, tuple) else (want,)))
                cs.require(res["bitwise_vs_parent"],
                           f"{label}: differs from the parent's kernel, max "
                           f"{(first(old) - first(want)).abs().max().item()}")
                t = [cs.median_ms(torch, f, c.flush)
                     for f in (par, fn, fn, par)]
                res["turns_ms"] = {"parent": [t[0], t[3]], "new": t[1:3]}
            out[label] = res
            print(f"   {label}: " + json.dumps(res), flush=True)
    finally:
        ss.gss_plan = chosen
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "k1_lane_plans.json"), "w",
              encoding="utf-8") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
