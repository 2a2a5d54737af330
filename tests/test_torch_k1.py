"""K1 (gather-scale-segment-sum, ``gss_forward``) and K4 (its int8-in
sibling, ``gssq_forward``) on lane groups: their lane plan
(``segment_sum.gss_plan`` over ``segment_sum.lane_plan``, the search K3
shares) and their walk (``gss_lanes_kernel`` in ``csrc/segment_sum.cu``).

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against the plain versions there).  Here the plan is checked to give
every column of a row to exactly one lane vector, inside its head, at
the widths the main path feeds K1 and K4, and the walk is emulated lane
by lane in numpy: chunks of G edges whose indices one lane each loads
and the group shares, NE edges' rows in flight before their FMAs, head
slices, a lane's vectors LPH apart, a column summed by one lane a head.
Each output element must equal, bit for bit, one fma per edge from zero
in edge order (``fmaf`` emulated in float64, where the product is
exact), and the plain versions within 1e-5 (rtol and atol: float32
summed in another order).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import gat_fused
from repro_torch.kernels import segment_sum as ss
from repro_torch.kernels.segment_sum import dst_layout

TOL = dict(rtol=1e-5, atol=1e-5)
SERVED, WHOLE = 1664, 232965       # destinations: a served block, a graph


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fma(c, x, acc):
    """``fmaf`` elementwise: c * x is exact in float64, then one sum."""
    return (np.float64(c) * np.asarray(x, np.float64)
            + np.asarray(acc, np.float64)).astype(np.float32)


def _lanes(heads, hd, plan):
    """(group, gl, h, sl, lih, vector indices) of each live lane of one
    destination's groups, as ``lanes::Lane`` and ``gss_lanes_kernel``
    place them (vector ``sl * lph * vpl + lih + u * lph`` of head ``h``)."""
    hpg, lph, vpl, nsl, G = (plan[k] for k in ("hpg", "lph", "vpl", "nsl",
                                               "group"))
    nhb = -(-heads * nsl // hpg)
    for hb in range(nhb):
        for gl in range(G):
            hv = hb * hpg + gl // lph
            h, sl, lih = hv // nsl, hv % nsl, gl % lph
            if gl // lph >= hpg or h >= heads:
                continue
            vb = sl * lph * vpl + lih
            yield hb, gl, h, sl, lih, [vb + u * lph for u in range(vpl)]


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

# (heads, hd, pointers' alignment, destinations): K1 at SAGE's layer 0
# (602, float2 rows 8-byte aligned), GCN's and SAGE's 256, GCN's 41, the
# GAT VJP's source pass (4 x 64, 4 x 10), the edge cases' 37, over a
# whole graph and a served block, K4's mini-batch block; a head wider
# than a warp (Cora's 1433)
PLAN_CASES = [(1, 602, 8, WHOLE), (1, 602, 8, SERVED), (1, 602, 16, WHOLE),
              (1, 256, 16, WHOLE), (1, 256, 16, SERVED), (1, 256, 16, 64),
              (1, 41, 4, WHOLE), (1, 41, 16, SERVED), (4, 64, 16, WHOLE),
              (4, 10, 16, WHOLE), (4, 10, 8, SERVED), (1, 37, 4, 30),
              (1, 1433, 4, WHOLE), (1, 1433, 4, 1000), (2, 800, 16, WHOLE),
              (1, 602, 8, 3946), (4, 64, 16, SERVED), (1, 1, 4, 5),
              (40, 3, 4, 10)]


def _check_plan(plan, heads, hd, align, quantized=False):
    """Every column of a row to exactly one lane vector, inside its head,
    under a plan whose instance is built."""
    vec, lph, G, vpl = plan["vec"], plan["lph"], plan["group"], plan["vpl"]
    assert hd % vec == 0 and align % (4 * vec) == 0
    assert vec == next(v for v in (4, 2, 1)
                       if hd % v == 0 and align % (4 * v) == 0)
    for n in (lph, G):
        assert n & (n - 1) == 0
    assert 1 <= plan["hpg"] * lph <= G <= ss.WARP
    assert 1 <= vpl <= ss.GSS_MAX_VPL
    assert plan["ne"] in ss.GSS_NES
    assert ss.gss_built(vec, vpl, plan["ne"], quantized)
    owner = {}
    for hb, gl, h, sl, lih, vecs in _lanes(heads, hd, plan):
        for v in vecs:
            if v >= hd // vec:
                continue
            for c in h * hd + v * vec + np.arange(vec):
                assert c // hd == h                  # inside its head
                assert c not in owner
                owner[c] = (hb, gl)
    assert sorted(owner) == list(range(heads * hd))


@pytest.mark.parametrize("heads,hd,align,num_dst", PLAN_CASES)
def test_gss_plan_gives_each_column_one_lane_vector_of_its_head(
        heads, hd, align, num_dst):
    _check_plan(ss.gss_plan(heads, hd, align, num_dst), heads, hd, align)
    if heads == 1:               # K4's plan over the same row
        _check_plan(ss.gss_plan(1, hd, align, num_dst, quantized=True),
                    1, hd, align, quantized=True)


def test_gss_plan_at_the_main_paths_widths():
    """SAGE's 602-wide rows: over the whole graph one warp of 10 float2 a
    lane (lane_plan alone, with K3's 8 vectors, cannot hold them), over a
    served block two warps of 5; GCN's 41: four lanes
    of 11 floats, eight destinations a warp, every lane working; the GAT
    VJP's 4 x 10: one lane of 5 float2 a head; 256 over a whole graph 16
    floats a lane, over a served block 8 (as K3 takes them)."""
    with pytest.raises(ValueError):
        ss.lane_plan(1, 602, 8, max_vpl=gat_fused.MAX_VPL)
    core = ("vec", "hpg", "lph", "vpl", "group", "nsl")

    def plan(*a):
        p = ss.gss_plan(*a)
        return tuple(p[k] for k in core)
    assert plan(1, 602, 8, WHOLE) == (2, 1, 32, 10, 32, 1)
    assert plan(1, 602, 8, SERVED) == (2, 1, 32, 5, 32, 2)
    assert plan(1, 41, 4, WHOLE) == (1, 1, 4, 11, 4, 1)
    assert plan(4, 10, 16, WHOLE) == (2, 4, 1, 5, 4, 1)
    assert plan(1, 256, 16, WHOLE) == (4, 1, 16, 4, 16, 1)
    assert plan(1, 256, 16, SERVED) == (4, 1, 32, 2, 32, 1)
    assert plan(4, 64, 16, WHOLE) == (4, 4, 4, 4, 16, 1)
    # a head wider than a warp of GSS_MAX_VPL vectors is cut into slices
    assert plan(1, 1433, 4, WHOLE)[-1] == 4


@pytest.mark.parametrize("F,align,num_dst", [(602, 8, 3946), (256, 16, 3946),
                                             (41, 4, 64), (2048, 16, 10)])
def test_k4_plan_fits_its_built_instances(F, align, num_dst):
    p = ss.gss_plan(1, F, align, num_dst, quantized=True)
    assert p["hpg"] == 1 and p["ne"] in ss.GSS_NES
    assert ss.gss_built(p["vec"], p["vpl"], p["ne"], quantized=True)
    assert p["nsl"] * p["lph"] * p["vpl"] * p["vec"] >= F
    assert len(ss._plan_args(p, quantized=True)) == 6
    assert len(ss._plan_args(p)) == 7


# ---------------------------------------------------------------------------
# the walk, emulated lane by lane
# ---------------------------------------------------------------------------

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


def _emulate(rows, idx, coef, order, row_ptr, D, plan, *, col=None,
             dq=None):
    """``gss_lanes_kernel`` lane by lane: ``rows`` (S, F) float32, or
    uint8 with ``dq = (mn, scale)`` (K4); ``coef`` (E,) or (E, heads)."""
    heads = 1 if coef.ndim == 1 else coef.shape[1]
    F = rows.shape[1]
    hd, vec, G, ne = F // heads, plan["vec"], plan["group"], plan["ne"]
    coef2 = coef.reshape(len(coef), heads)
    col2 = None if col is None else col.reshape(len(col), heads)
    out = np.full((D, F), np.nan, np.float32)
    col_out = np.full((D, heads), np.nan, np.float32)
    written = np.zeros((D, F), int)
    for d in range(D):
        k0, k1 = row_ptr[d], row_ptr[d + 1]
        for _, _, h, sl, lih, vecs in _lanes(heads, hd, plan):
            cols = [h * hd + v * vec + np.arange(vec) for v in vecs
                    if v < hd // vec]
            cols = np.concatenate(cols) if cols else np.zeros(0, int)
            acc = np.zeros(len(cols), np.float32)
            owner = col2 is not None and sl == 0 and lih == 0
            csum = np.float32(0)
            for kc in range(k0, k1, G):
                n = min(G, k1 - kc)
                # lane j of the group loads edge j's entries; all share them
                e_ch = order[kc:kc + n]
                s_ch = idx[e_ch]
                for i0 in range(0, n, ne):
                    js = range(i0, min(i0 + ne, n))
                    # the rows of ne edges in flight, then FMAs in order
                    x = {j: rows[s_ch[j], cols] for j in js}
                    for j in js:
                        e, s = e_ch[j], s_ch[j]
                        xj = x[j] if dq is None else _fma(
                            x[j].astype(np.float32), dq[1][s, 0], dq[0][s, 0])
                        acc = _fma(coef2[e, h], xj, acc)
                        if owner:
                            csum = np.float32(csum + col2[e, h])
            out[d, cols] = acc
            written[d, cols] += 1
            if owner:
                col_out[d, h] = csum
    assert (written == 1).all()
    return out, col_out


def _edge_order(rows, idx, coef, order, row_ptr, D, *, col=None, dq=None):
    """One fma per edge from zero in edge order, every column at once."""
    heads = 1 if coef.ndim == 1 else coef.shape[1]
    F = rows.shape[1]
    coef2 = coef.reshape(len(coef), heads)
    out = np.zeros((D, F), np.float32)
    col_out = np.zeros((D, heads), np.float32)
    for d in range(D):
        for k in range(row_ptr[d], row_ptr[d + 1]):
            e, s = order[k], idx[order[k]]
            x = rows[s] if dq is None else _fma(rows[s].astype(np.float32),
                                                dq[1][s, 0], dq[0][s, 0])
            out[d] = _fma(np.repeat(coef2[e], F // heads), x, out[d])
            if col is not None:
                col_out[d] = col.reshape(len(col), heads)[e] + col_out[d]
    return out, col_out


# (heads, hd, alignment, destinations for the plan, ne): the main path's
# plans (602 over a served block is two slices), other edges in flight
WALKS = [(1, 602, 8, WHOLE, None), (1, 602, 8, SERVED, None),
         (1, 41, 4, WHOLE, None), (1, 41, 4, WHOLE, 2),
         (4, 10, 16, WHOLE, None), (4, 16, 16, WHOLE, 4),
         (1, 256, 16, SERVED, 2), (1, 37, 4, 30, None),
         (2, 1100, 8, WHOLE, 1)]


@pytest.mark.parametrize("heads,hd,align,num_dst,ne", WALKS)
def test_k1_walk_emulated_is_the_edge_order_sum_bitwise(heads, hd, align,
                                                        num_dst, ne):
    """Several chunks at destination 0, masked edges, an unreached
    destination; a column summed beside the rows (the GAT VJP's source
    pass) with per-head coefficients."""
    S, D = 30, 10
    src, dst, mask = _graph(hd, S, D, 50, 5, heavy=40)
    rng = np.random.default_rng(hd + heads)
    rows = rng.standard_normal((S, heads * hd)).astype(np.float32)
    coef = rng.standard_normal((len(src), heads) if heads > 1
                               else len(src)).astype(np.float32)
    col = rng.standard_normal((len(src), heads)).astype(np.float32)
    order, row_ptr = dst_layout(dst, D, mask)
    plan = ss.gss_plan(heads, hd, align, num_dst)
    if ne is not None:
        plan["ne"] = ne
    got, got_col = _emulate(rows, src, coef, order, row_ptr, D, plan, col=col)
    want, want_col = _edge_order(rows, src, coef, order, row_ptr, D, col=col)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_col, want_col)
    assert (got[D - 1] == 0).all() and (got_col[D - 1] == 0).all()
    p_out, p_col = ss.gather_scale_segment_sum_plain(
        _t(rows), _t(src), _t(coef), _t(order), _t(row_ptr), D, col=_t(col))
    np.testing.assert_allclose(got, p_out.numpy(), **TOL)
    np.testing.assert_allclose(got_col, p_col.numpy(), **TOL)


@pytest.mark.parametrize("F,align,ne", [(602, 8, None), (602, 8, 1),
                                        (41, 4, None), (64, 16, 4)])
def test_k4_walk_emulated_is_the_edge_order_sum_bitwise(F, align, ne):
    """K4: uint8 rows (uchar2 at 602 bytes), scale and mn loaded by the
    edge's lane and shared, ``fmaf(c, fmaf(q, scale, mn), acc)``."""
    S, D = 24, 9
    src, dst, mask = _graph(F, S, D, 45, 4, heavy=36)
    rng = np.random.default_rng(F)
    q = rng.integers(0, 256, (S, F)).astype(np.uint8)
    mn = rng.standard_normal((S, 1)).astype(np.float32)
    scale = (rng.random((S, 1)) / 255).astype(np.float32)
    coef = rng.standard_normal(len(src)).astype(np.float32)
    order, row_ptr = dst_layout(dst, D, mask)
    plan = ss.gss_plan(1, F, align, D, quantized=True)
    if ne is not None:
        plan["ne"] = ne
    got, _ = _emulate(q, src, coef, order, row_ptr, D, plan, dq=(mn, scale))
    want, _ = _edge_order(q, src, coef, order, row_ptr, D, dq=(mn, scale))
    np.testing.assert_array_equal(got, want)
    plain = ss.gather_scale_segment_sum_q_plain(
        _t(q), _t(mn), _t(scale), _t(src), _t(coef), _t(order), _t(row_ptr),
        D)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)


def test_the_lane_walk_is_one_header_shared_by_both_sources():
    """K1 / K4 and K3 share ``lanes.cuh`` (the Lane walk, vector loads and
    stores) rather than copies of it."""
    from repro_torch.kernels import build
    assert (build.CSRC / "lanes.cuh").is_file()
    for name in ("segment_sum.cu", "gat_fused.cu"):
        text = (build.CSRC / name).read_text()
        assert '#include "lanes.cuh"' in text
        assert "struct Lane" not in text and "void load_vec" not in text


def test_gss_plan_is_one_search_per_shape_and_its_plans_are_callers_own():
    a = ss.gss_plan(1, 602, 8, WHOLE)
    a["ne"] = 99
    assert ss.gss_plan(1, 602, 8, WHOLE + 1)["ne"] != 99
    assert ss.gss_plan(1, 602, 8, WHOLE) == ss.gss_plan(1, 602, 8, 1 << 20)
    info = ss._gss_plan.cache_info()
    ss.gss_plan(1, 602, 8, WHOLE)
    assert ss._gss_plan.cache_info().hits == info.hits + 1


def test_only_the_instances_a_plan_can_pick_are_built():
    """``gss_built`` (the source's ``gss_instance``) holds every plan
    over a range of widths, heads, alignments and both kinds of layout,
    and little more: each built instance of K4 is some plan's pick, and
    of K1 all but a few whose block budget applies to rows a block plan
    never gives a lane (more than BLOCK_FLOATS floats)."""
    picked = {False: set(), True: set()}
    for quantized in (False, True):
        for heads in ((1,) if quantized else (1, 2, 4, 8, 33)):
            for hd in range(1, 1600):
                for align in (4, 8, 16):
                    for num_dst in (10, WHOLE):
                        p = ss.gss_plan(heads, hd, align, num_dst,
                                        quantized=quantized)
                        assert ss.gss_built(p["vec"], p["vpl"], p["ne"],
                                            quantized)
                        picked[quantized].add((p["vec"], p["vpl"], p["ne"]))
    for quantized in (False, True):
        built = {(v, n, e) for v in (1, 2, 4) for n in range(1, 13)
                 for e in ss.GSS_NES if ss.gss_built(v, n, e, quantized)}
        assert picked[quantized] <= built
        assert all(v * n > ss.BLOCK_FLOATS and e == ss.gss_ne(
            v * n, ss.GSS_MAX_WORDS) for v, n, e in built - picked[quantized])
        assert len(built) == (36 if quantized else 60)
    assert not ss.gss_built(2, 10, 2) and not ss.gss_built(2, 5, 4, True)


def test_the_sources_plan_limits_are_the_wrappers():
    from repro_torch.kernels import build
    text = (build.CSRC / "segment_sum.cu").read_text()
    for name in ("GSS_MAX_VPL", "GSS_WHOLE_WORDS", "GSS_MAX_WORDS"):
        assert f"constexpr int {name} = {getattr(ss, name)};" in text


def test_the_c_signatures_take_the_plan_as_the_wrappers_pass_it():
    from repro_torch.kernels import build
    sigs = build.SIGNATURES["segment_sum"]
    plan = ss.gss_plan(1, 602, 8, WHOLE)
    # pointers, then num_dst, F (and heads), the plan, the stream
    assert len(sigs["gss_forward"]) == 8 + 3 + len(ss._plan_args(plan)) + 1
    assert len(sigs["gssq_forward"]) == (
        8 + 2 + len(ss._plan_args(plan, quantized=True)) + 1)
