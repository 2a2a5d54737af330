#!/usr/bin/env python3
"""Time GAT's two kernels (K3 and its VJP's destination pass,
``src/repro_torch/kernels/csrc/gat_fused.cu``) under each candidate lane
plan, on the card, at the shapes ``chip_smoke.py`` checks them: K3 over
GAT's 40-class Reddit-width graph at 4 x 64 and 4 x 10 and on a served
inner block (1 664 destinations, fanout 10), the destination pass over
the graph at 4 x 64 and 4 x 10.  The plan ``gat_fused.lane_plan`` picks
is marked; every result is checked against the plain version first.

    python3 scripts/gat_lane_plans.py      # from the root of a checkout

Prints one JSON object: per case, the median ms (CUDA events, L2
flushed, as ``chip_smoke.median_ms``) of each plan.
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (puts src/ on the path)


def plans(heads, hd):
    """Every plan of at most MAX_VPL vectors a lane that fills whole
    heads, one group holding all heads (as lane_plan searches them)."""
    from repro_torch.kernels import gat_fused as gf
    from repro_torch.kernels import segment_sum as ss
    vec = next(v for v in (4, 2, 1) if hd % v == 0)
    out, lph = [], 1
    while heads * lph <= ss.WARP:
        vpl = -(-(hd // vec) // lph)
        if vpl <= gf.MAX_VPL:
            out.append({"vec": vec, "hpg": heads, "lph": lph, "vpl": vpl,
                        "group": 1 << (heads * lph - 1).bit_length()})
        lph *= 2
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gat_lane_plans: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core.abstraction import DeviceGraph
    from repro_torch.kernels import gat_fused as gf
    from repro_torch.kernels import segment_sum as ss
    dev = torch.device("cuda")
    c = cs.Checker(torch, seed=3)
    dga = DeviceGraph.from_graph(cs.reddit_graph(cs.GAT_CLASSES), dev)
    blocks, _ = cs.sampled_blocks(cs.reddit_graph(), cs.FANOUTS)
    g_in = DeviceGraph.from_block(blocks[0], dev)
    cases = []
    for label, gr, hd in (("K3 4x64", dga, 64), ("K3 4x10", dga, 10),
                          ("K3 served 4x64", g_in, 64)):
        D = gr.num_dst
        args = (c.randn(gr.num_src, 4 * hd), c.randn(gr.num_src, 4),
                c.randn(D, 4), gr.edge_src, gr.order, gr.row_ptr, D)
        cases.append((label, hd, D, lambda a=args: gf.gat_attention_cuda(*a),
                      gf.gat_attention_plain(*args)))
    for hd in (64, 10):
        N = dga.num_src
        hs, es, ed = c.randn(N, 4 * hd), c.randn(N, 4), c.randn(N, 4)
        _, m, l = gf.gat_attention_plain(hs, es, ed, dga.edge_src, dga.order,
                                         dga.row_ptr, N, stats=True)
        args = (c.randn(N, 4 * hd), hs, es, ed, m, l, dga.edge_src,
                dga.order, dga.row_ptr, dga.edge_src.numel())
        cases.append((f"VJP dst pass 4x{hd}", hd, N,
                      lambda a=args: gf.gat_backward_dst_cuda(*a)[1],
                      gf.gat_backward_dst_plain(*args)[1]))
    chosen = gf.lane_plan
    out = {"card": cs.nvidia_smi_line()}
    try:
        for label, hd, D, fn, ref in cases:
            picked = chosen(4, hd, 16, ss._floats_per_lane(D),
                            max_vpl=gf.MAX_VPL)
            rows = []
            for plan in plans(4, hd):
                gf.lane_plan = lambda *a, p=plan, **k: p
                got = fn()
                torch.cuda.synchronize()
                err = (got - ref).abs().max().item()
                cs.require(err <= 1e-4 * ref.abs().max().item(),
                           f"{label} {plan}: error {err}")
                rows.append({"plan": plan, "picked": plan == picked,
                             "ms": cs.median_ms(torch, fn, c.flush)})
            out[label] = rows
    finally:
        gf.lane_plan = chosen
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
