"""K6 (the edge dot, ``edge_dot``) on lane groups over the dst-grouped
layout: its lane plan (``segment_sum.edge_dot_plan`` over
``segment_sum.lane_plan``) and its walk (``edge_dot_lanes_kernel`` in
``csrc/segment_sum.cu``).

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it
against the plain version there).  Here the plan is checked to give
every column of a head to exactly one lane vector at the widths the
reference's dcoef and GAT's heads give K6, and the walk is emulated lane
by lane in numpy: a group holding its destination's ``b`` vectors,
chunks of G edges whose indices one lane each loads and the group
shares, NE edges in flight, heads cut into slices walked in turn.  Each
(edge, head) must equal, bit for bit, the per-head sum in the kernel's
order (each lane's fma chain over its slices, vectors and elements, then
a butterfly over the head's lanes; ``fmaf`` emulated in float64, where
the product is exact), and the plain version within 1e-5 (rtol and atol:
float32 summed in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import segment_sum as ss
from repro_torch.kernels.segment_sum import dst_layout

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fma(x, y, acc):
    """``fmaf`` elementwise: x * y is exact in float64, then one sum."""
    return (np.asarray(x, np.float64) * np.asarray(y, np.float64)
            + np.asarray(acc, np.float64)).astype(np.float32)


def _lanes(heads, hd, plan):
    """(group, h, lih, columns in chain order) of each live lane of one
    destination's groups, as ``lanes::Lane`` and ``edge_dot_lanes_kernel``
    place them: slice sl, vector u, element t of lane lih of head h reads
    column h * hd + (sl * lph * vpl + lih + u * lph) * vec + t."""
    vec, hpg, lph, vpl, nsl, G = (plan[k] for k in (
        "vec", "hpg", "lph", "vpl", "nsl", "group"))
    for hb in range(-(-heads // hpg)):
        for gl in range(G):
            h, lih = hb * hpg + gl // lph, gl % lph
            if gl // lph >= hpg or h >= heads:
                continue
            cols = [h * hd + v * vec + t
                    for sl in range(nsl) for u in range(vpl)
                    for v in [sl * lph * vpl + lih + u * lph]
                    if v < hd // vec for t in range(vec)]
            yield hb, h, lih, cols


def _butterfly(vals):
    """The head's lanes' partials added by ``__shfl_xor_sync`` at offsets
    lph / 2 .. 1: lane 0's sum."""
    vals = list(vals)
    o = len(vals) // 2
    while o:
        vals = [np.float32(vals[i] + vals[i ^ o]) for i in range(len(vals))]
        o //= 2
    return vals[0]


def _kernel_order(a, b, idx, order, row_ptr, heads, plan):
    """Every listed (edge, head) at once: each lane's fma chain, then the
    butterfly, with no walk."""
    D, F = b.shape[0], a.shape[1]
    seg = np.repeat(np.arange(D), np.diff(row_ptr))
    A, B = a[idx[order]], b[seg]
    lanes = {}
    for _, h, lih, cols in _lanes(heads, F // heads, plan):
        acc = np.zeros(len(order), np.float32)
        for c in cols:
            acc = _fma(A[:, c], B[:, c], acc)
        lanes[h, lih] = acc
    out = np.zeros((len(idx), heads), np.float32)
    for h in range(heads):
        parts = [lanes[h, i] for i in range(plan["lph"])]
        out[order, h] = [_butterfly(p[k] for p in parts)
                         for k in range(len(order))]
    return out


def _emulate(a, b, idx, order, row_ptr, heads, plan):
    """``edge_dot_lanes_kernel`` group by group: b's vectors held, chunks
    of G edges, NE edges' vectors in flight before their FMAs, the head's
    first lane writing each (edge, head) once; unlisted edges stay 0."""
    D, F = b.shape[0], a.shape[1]
    G, ne = plan["group"], plan["ne"]
    out = np.zeros((len(idx), heads), np.float32)
    written = np.zeros((len(idx), heads), int)
    lanes = list(_lanes(heads, F // heads, plan))
    for d in range(D):
        k0, k1 = row_ptr[d], row_ptr[d + 1]
        held = {(h, lih): b[d, cols] for _, h, lih, cols in lanes}
        for kc in range(k0, k1, G):
            n = min(G, k1 - kc)
            e_ch = order[kc:kc + n]            # lane j loads edge j's
            s_ch = idx[e_ch]
            for i0 in range(0, n, ne):
                js = range(i0, min(i0 + ne, n))
                rows = {j: a[s_ch[j]] for j in js}     # in flight
                for j in js:
                    part = {}
                    for _, h, lih, cols in lanes:
                        acc = np.float32(0)
                        for x, y in zip(rows[j][cols], held[h, lih]):
                            acc = _fma(x, y, acc)
                        part[h, lih] = acc
                    for h in range(heads):
                        out[e_ch[j], h] = _butterfly(
                            part[h, i] for i in range(plan["lph"]))
                        written[e_ch[j], h] += 1
    listed = np.zeros(len(idx), bool)
    listed[order] = True
    assert (written[listed] == 1).all() and (written[~listed] == 0).all()
    return out


def _graph(seed, S, D, E, n_pad, heavy):
    """Edges with duplicates, masked edges, trailing pad slots, the last
    destination unreached and destination 0 reached ``heavy`` more times
    (more edges than a group has lanes: several chunks)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, S, E + heavy),
                          np.zeros(n_pad, np.int64)]).astype(np.int32)
    dst = np.concatenate([rng.integers(0, D - 1, E),
                          np.zeros(heavy + n_pad, np.int64)]).astype(np.int32)
    mask = rng.random(len(src)) >= 0.2
    mask[len(src) - n_pad:] = False
    return src, dst, mask


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads,hd,align", [
    (1, 256, 16), (4, 64, 16), (4, 10, 16), (4, 10, 8), (1, 256, 4),
    (1, 602, 8), (1, 1433, 4), (2, 1100, 8), (40, 3, 4), (1, 37, 4),
    (1, 1, 4)])
def test_edge_dot_plan_gives_each_column_one_lane_vector_of_its_head(
        heads, hd, align):
    plan = ss.edge_dot_plan(heads, hd, align)
    vec, lph, G, vpl = plan["vec"], plan["lph"], plan["group"], plan["vpl"]
    assert vec == next(v for v in (4, 2, 1)
                       if hd % v == 0 and align % (4 * v) == 0)
    for n in (lph, G):
        assert n & (n - 1) == 0
    assert 1 <= plan["hpg"] * lph <= G <= ss.WARP
    assert 1 <= vpl <= ss.ED_MAX_VPL
    assert plan["ne"] == ss.gss_ne(vpl * vec, ss.ED_WORDS)
    owner = {}
    for hb, h, lih, cols in _lanes(heads, hd, plan):
        for c in cols:
            assert c // hd == h and c not in owner     # inside its head
            owner[c] = (hb, h, lih)
    assert sorted(owner) == list(range(heads * hd))


def test_edge_dot_plan_at_the_phase_5_shapes():
    """8 floats a lane over a whole graph and a block alike (the plan
    does not ask how many destinations there are): 1 × 256 a
    warp of 2 float4 a lane, 4 × 64 a destination's four heads in a warp
    of 8 lanes a head, 2 float4 each, both with 4 edges in flight; 4 × 10
    one lane of 5 float2 a head, eight destinations a warp, two edges in
    flight."""
    core = ("vec", "hpg", "lph", "vpl", "group", "nsl", "ne")

    def plan(*a):
        p = ss.edge_dot_plan(*a)
        return tuple(p[k] for k in core)
    assert plan(1, 256, 16) == (4, 1, 32, 2, 32, 1, 4)
    assert plan(4, 64, 16) == (4, 4, 8, 2, 32, 1, 4)
    assert plan(4, 10, 16) == (2, 4, 1, 5, 4, 1, 2)
    # a head wider than a warp of ED_MAX_VPL vectors is walked in slices
    assert plan(1, 1433, 4)[-2] == 6


def test_edge_dot_plan_is_one_search_per_shape_and_its_plans_are_callers_own():
    a = ss.edge_dot_plan(1, 256, 16)
    a["ne"] = 99
    assert ss.edge_dot_plan(1, 256, 16)["ne"] != 99
    info = ss._edge_dot_plan.cache_info()
    ss.edge_dot_plan(1, 256, 16)
    assert ss._edge_dot_plan.cache_info().hits == info.hits + 1


def test_the_sources_plan_limits_and_signature_are_the_wrappers():
    text = (build.CSRC / "segment_sum.cu").read_text()
    for name in ("ED_MAX_VPL", "ED_WORDS"):
        assert f"constexpr int {name} = {getattr(ss, name)};" in text
    # pointers (a, b, src, order, row_ptr, out), num_dst, F, heads, the
    # plan's six numbers, the stream
    assert len(build.SIGNATURES["segment_sum"]["edge_dot"]) == 6 + 3 + 6 + 1


# ---------------------------------------------------------------------------
# the walk, emulated lane by lane
# ---------------------------------------------------------------------------

# (heads, hd, alignment, ne): phase 5's three shapes, float2 and single
# floats, sliced heads, more heads than a warp has lanes, other edges in
# flight
WALKS = [(1, 256, 16, None), (4, 64, 16, None), (4, 10, 16, None),
         (1, 256, 8, None), (2, 1100, 8, None), (40, 3, 4, None),
         (1, 37, 4, None), (4, 16, 16, 1), (4, 10, 16, 1),
         (1, 256, 16, 2)]


@pytest.mark.parametrize("heads,hd,align,ne", WALKS)
def test_k6_walk_emulated_is_the_kernel_order_sum_bitwise(heads, hd, align,
                                                          ne):
    """Several chunks at destination 0, masked edges (unlisted: zero), an
    unreached destination; the walk bitwise equal to the per-head sums in
    the kernel's order, both within float32 roundoff of the plain
    version."""
    S, D = 30, 10
    src, dst, mask = _graph(hd + heads, S, D, 50, 5, heavy=40)
    rng = np.random.default_rng(7 * hd + heads)
    a = rng.standard_normal((S, heads * hd)).astype(np.float32)
    b = rng.standard_normal((D, heads * hd)).astype(np.float32)
    order, row_ptr = dst_layout(dst, D, mask)
    plan = ss.edge_dot_plan(heads, hd, align)
    if ne is not None:
        plan["ne"] = ne
    got = _emulate(a, b, src, order, row_ptr, heads, plan)
    want = _kernel_order(a, b, src, order, row_ptr, heads, plan)
    np.testing.assert_array_equal(got, want)
    assert (got[~mask] == 0).all()
    plain = ss.edge_dot_plain(_t(a), _t(b), _t(src), _t(order), _t(row_ptr),
                              heads)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)


def test_edge_dot_plain_reads_b_by_the_layouts_destination():
    """The plain version takes each listed edge's destination from
    ``row_ptr``, not from an edge list: the old (edge_src, edge_dst)
    form's values on a layout built from that edge_dst."""
    S, D, F = 12, 7, 6
    src, dst, mask = _graph(3, S, D, 30, 3, heavy=5)
    rng = np.random.default_rng(3)
    a = rng.standard_normal((S, F)).astype(np.float32)
    b = rng.standard_normal((D, F)).astype(np.float32)
    order, row_ptr = dst_layout(dst, D, mask)
    got = ss.edge_dot_plain(_t(a), _t(b), _t(src), _t(order), _t(row_ptr),
                            2).numpy()
    want = np.zeros((len(src), 2), np.float32)
    for e in order:
        want[e] = (a[src[e]] * b[dst[e]]).reshape(2, 3).sum(-1)
    np.testing.assert_allclose(got, want, **TOL)
