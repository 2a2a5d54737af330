"""GAT's kernels in the port: K3 (``gat_fused.gat_attention_*``) and its
VJP, a destination pass (``gat_backward_dst_*``) and a source pass (K1
over the src-grouped layout summing a column), against the reference's
custom VJP (``jax.vjp`` through ``gat_fused_attention_pallas`` in
interpret mode) on identical numpy inputs, with masked edges and
destinations that no edge reaches.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against these plain versions there).  What can be checked here is their
launch plan (``segment_sum.lane_plan`` with ``gat_fused.MAX_VPL`` vectors
a lane), and their walk: the emulations below
repeat, lane by lane in float32 numpy, the index arithmetic and the order
of operations of ``csrc/gat_fused.cu`` (chunks of G edges shared by a
group, the online softmax, the xor tree over a head's lanes, the second
walk for dpre).  Tolerance 1e-5 (rtol and atol), as in
``tests/test_torch_kernels.py``: float32 summed in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gat_fused as ref_gat
from repro.kernels import segment_sum as ref_ss
from repro_torch.kernels import gat_fused, ops, segment_sum
from repro_torch.kernels.segment_sum import dst_layout

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _k3_plan(*args, **kw):
    """K3's lane plan, as ``gat_fused`` asks ``segment_sum.lane_plan``."""
    return segment_sum.lane_plan(*args, max_vpl=gat_fused.MAX_VPL, **kw)


def _graph(seed, S, D, E, n_pad, *, heavy=0):
    """Edges with duplicates, masked edges, trailing pad slots (src 0, dst
    0, masked, as the samplers emit them), the last destination unreached
    and, with ``heavy``, destination 0 reached ``heavy`` more times (more
    edges than a group has lanes)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, S, E)
    dst = rng.integers(0, D - 1, E)
    src = np.concatenate([src, rng.integers(0, S, heavy),
                          np.zeros(n_pad, np.int64)]).astype(np.int32)
    dst = np.concatenate([dst, np.zeros(heavy + n_pad, np.int64)]
                         ).astype(np.int32)
    mask = rng.random(len(src)) >= 0.2
    mask[len(src) - n_pad:] = False
    return src, dst, mask


def _inputs(seed, S, D, heads, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((S, heads * hd)).astype(np.float32),
            rng.standard_normal((S, heads)).astype(np.float32),
            rng.standard_normal((D, heads)).astype(np.float32),
            rng.standard_normal((D, heads * hd)).astype(np.float32))


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

PLAN_SHAPES = [(4, 64), (4, 10), (4, 16), (4, 1), (4, 3), (2, 5), (3, 8),
               (1, 256), (32, 8), (32, 64), (4, 0), (1, 1)]


@pytest.mark.parametrize("heads,hd", PLAN_SHAPES)
@pytest.mark.parametrize("align", [16, 8, 4])
def test_lane_plan_gives_each_column_one_lane_of_its_head(heads, hd, align):
    p = _k3_plan(heads, hd, align)
    vec, hpg, lph, G = p["vec"], p["hpg"], p["lph"], p["group"]
    assert hd % vec == 0 and align % (4 * vec) == 0
    assert vec == next(v for v in (4, 2, 1)
                       if hd % v == 0 and align % (4 * v) == 0)
    for n in (lph, G):
        assert n & (n - 1) == 0
    assert 1 <= hpg <= heads and hpg * lph <= G <= 32
    assert 1 <= p["vpl"] <= gat_fused.MAX_VPL
    owner = {}
    for hb, gl, h, _, cols in _lanes(heads, hd, p):
        for c in cols:
            for col in ([] if c is None else c):
                assert col // hd == h                  # inside its head
                assert col not in owner
                owner[col] = (hb, gl)
    assert sorted(owner) == list(range(heads * hd))


def test_lane_plan_fills_every_lane_at_gats_widths():
    """GAT's two layers: 4 x 64 (float4, 8 lanes of 2 vectors a head, one
    destination a warp; the forward over a whole graph, 4 lanes of 4, two
    destinations a warp) and 4 x 10 (float2, one lane of 5 vectors a head,
    eight destinations a warp), no idle lane or vector slot."""
    assert _k3_plan(4, 64) == {"vec": 4, "hpg": 4, "lph": 8, "vpl": 2,
                               "group": 32}
    assert _k3_plan(4, 64, floats_per_lane=16) == {
        "vec": 4, "hpg": 4, "lph": 4, "vpl": 4, "group": 16}
    for fpl in (8, 16):
        assert _k3_plan(4, 10, floats_per_lane=fpl) == {
            "vec": 2, "hpg": 4, "lph": 1, "vpl": 5, "group": 4}


@pytest.mark.parametrize("heads,hd", [(33, 1), (2, 1025), (0, 4)])
def test_lane_plan_refuses_what_one_warp_cannot_hold(heads, hd):
    with pytest.raises(ValueError):
        _k3_plan(heads, hd)


# ---------------------------------------------------------------------------
# the kernels' walks, emulated lane by lane
# ---------------------------------------------------------------------------

def _lanes(heads, hd, plan):
    """(head block, gl, h, v0) of each live lane of a destination's groups,
    and the column indices of its vpl vectors (None past the head)."""
    vec, hpg, lph = plan["vec"], plan["hpg"], plan["lph"]
    vpl, G = plan["vpl"], plan["group"]
    nvh = hd // vec
    for hb in range(-(-heads // hpg)):
        for gl in range(G):
            h, v0 = hb * hpg + gl // lph, (gl % lph) * vpl
            if gl // lph < hpg and h < heads:
                yield hb, gl, h, v0, [
                    np.arange(vec) + h * hd + (v0 + u) * vec
                    if v0 + u < nvh else None for u in range(vpl)]


def _emulate_forward(hs, es, ed, src, order, row_ptr, D, plan):
    f32 = np.float32
    heads = es.shape[1]
    hd = hs.shape[1] // heads
    G = plan["group"]
    out = np.full((D, heads * hd), np.nan, f32)
    m_out = np.full((D, heads), np.nan, f32)
    l_out = np.full((D, heads), np.nan, f32)
    for d in range(D):
        k0, k1 = row_ptr[d], row_ptr[d + 1]
        for _, _, h, v0, cols in _lanes(heads, hd, plan):
            m, l = f32(-1e30), f32(0)
            acc = [np.zeros(len(c), f32) if c is not None else None
                   for c in cols]
            for kc in range(k0, k1, G):          # chunks of G edges
                for k in range(kc, min(kc + G, k1)):
                    s = src[order[k]]
                    pre = f32(es[s, h] + ed[d, h])
                    z = pre if pre >= 0 else f32(f32(0.2) * pre)
                    mb = max(m, z)
                    c, p = np.exp(f32(m - mb)), np.exp(f32(z - mb))
                    l = f32(l * c + p)
                    acc = [a * c + p * hs[s, col] if a is not None else None
                           for a, col in zip(acc, cols)]
                    m = mb
            for a, col in zip(acc, cols):
                if col is not None:
                    out[d, col] = a / f32(l + f32(1e-9))
            if v0 == 0:
                m_out[d, h], l_out[d, h] = m, l
    return out, m_out, l_out


def _emulate_backward_dst(g, hs, es, ed, m, l, src, order, row_ptr, E, plan):
    f32 = np.float32
    heads = es.shape[1]
    hd = hs.shape[1] // heads
    lph, G = plan["lph"], plan["group"]
    alpha = np.zeros((E, heads), f32)
    dpre = np.zeros((E, heads), f32)
    ded = np.full((len(row_ptr) - 1, heads), np.nan, f32)
    for d in range(len(row_ptr) - 1):
        k0, k1 = row_ptr[d], row_ptr[d + 1]
        lanes = list(_lanes(heads, hd, plan))
        for h in range(heads):
            mine = [ln for ln in lanes if ln[2] == h]
            assert len(mine) == lph
            den = f32(l[d, h] + f32(1e-9))
            s_dh = f32(0)
            for kc in range(k0, k1, G):          # chunks of G edges
                for k in range(kc, min(kc + G, k1)):
                    e = order[k]
                    s = src[e]
                    # each lane's partial dot, then the xor tree
                    parts = [f32(sum((g[d, c] * hs[s, c]).sum(dtype=f32)
                                     for c in cols if c is not None))
                             for *_, cols in mine]
                    o = lph // 2
                    while o:
                        parts = [f32(parts[j] + parts[j ^ o])
                                 for j in range(lph)]
                        o //= 2
                    assert len(set(parts)) == 1   # the same in each lane
                    pre = f32(es[s, h] + ed[d, h])
                    z = pre if pre >= 0 else f32(f32(0.2) * pre)
                    a = f32(np.exp(f32(z - m[d, h])) / den)
                    s_dh = f32(s_dh + a * parts[0])
                    alpha[e, h], dpre[e, h] = a, parts[0]
            # walk 2: lane lih takes edges k0 + lih, k0 + lih + lph, ...;
            # the lanes' sums meet in the xor tree
            accs = [f32(0)] * lph
            for lih in range(lph):
                for k in range(k0 + lih, k1, lph):
                    e = order[k]
                    pre = f32(es[src[e], h] + ed[d, h])
                    dp = f32(alpha[e, h] * f32(dpre[e, h] - s_dh)
                             * (f32(1) if pre >= 0 else f32(0.2)))
                    dpre[e, h] = dp
                    accs[lih] = f32(accs[lih] + dp)
            o = lph // 2
            while o:
                accs = [f32(accs[j] + accs[j ^ o]) for j in range(lph)]
                o //= 2
            ded[d, h] = accs[0]
    return alpha, dpre, ded


@pytest.mark.parametrize("heads,hd,fpl", [(4, 10, 8), (4, 16, 8),
                                          (4, 16, 4), (2, 3, 8)])
def test_kernel_walks_emulated_match_the_plain_versions(heads, hd, fpl):
    """Both kernels' walks, emulated, against the plain versions: one
    destination with more edges than a group has lanes (several chunks),
    masked edges, an unreached destination."""
    S, D = 30, 12
    src, dst, mask = _graph(hd, S, D, 60, 5, heavy=40)
    hs, es, ed, g = _inputs(hd, S, D, heads, hd)
    order, row_ptr = dst_layout(dst, D, mask)
    plan = _k3_plan(heads, hd, floats_per_lane=fpl)
    out, m, l = _emulate_forward(hs, es, ed, src, order, row_ptr, D, plan)
    p_out, p_m, p_l = gat_fused.gat_attention_plain(
        _t(hs), _t(es), _t(ed), _t(src), _t(order), _t(row_ptr), D,
        stats=True)
    np.testing.assert_allclose(out, p_out.numpy(), **TOL)
    np.testing.assert_array_equal(m, p_m.numpy())         # the max is exact
    np.testing.assert_allclose(l, p_l.numpy(), **TOL)
    assert (out[D - 1] == 0).all() and (l[D - 1] == 0).all()
    got = _emulate_backward_dst(g, hs, es, ed, m, l, src, order, row_ptr,
                                len(src), plan)
    want = gat_fused.gat_backward_dst_plain(
        _t(g), _t(hs), _t(es), _t(ed), _t(m), _t(l), _t(src), _t(order),
        _t(row_ptr), len(src))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b.numpy(), **TOL)
    assert (got[0][~mask] == 0).all() and (got[1][~mask] == 0).all()
    assert (got[2][D - 1] == 0).all()


# ---------------------------------------------------------------------------
# the plain versions against the reference's custom VJP
# ---------------------------------------------------------------------------

def _reference_vjp(hs, es, ed, src, dst, mask, g, D, heads):
    _, vjp = jax.vjp(lambda a, b, c: ref_gat.gat_fused_attention_pallas(
        a, b, c, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), D,
        heads=heads, interpret=True), jnp.asarray(hs), jnp.asarray(es),
        jnp.asarray(ed))
    return [np.asarray(r) for r in vjp(jnp.asarray(g))]


def _port_passes(hs, es, ed, src, dst, mask, g, S, D):
    """The port's VJP pass by pass, through ``ops`` (plain on the CPU)."""
    order, row_ptr = (_t(a) for a in dst_layout(dst, D, mask))
    order_s, row_ptr_s = (_t(a) for a in dst_layout(src, S, mask))
    _, m, l = ops.gat_attention(_t(hs), _t(es), _t(ed), _t(src), order,
                                row_ptr, D, stats=True)
    alpha, dpre, ded = ops.gat_backward_dst(
        _t(g), _t(hs), _t(es), _t(ed), m, l, _t(src), order, row_ptr,
        len(src))
    dhs, des = ops.gather_scale_segment_sum(
        _t(g), _t(dst), alpha, order_s, row_ptr_s, S, transpose=True,
        col=dpre)
    return dhs, des, ded, alpha, dpre


@pytest.mark.parametrize("heads,hd", [(4, 10), (4, 16)])
def test_each_vjp_pass_matches_the_reference_custom_vjp(heads, hd):
    """The destination pass gives ``ded``, the source pass ``dhs`` and
    ``des``: each against the reference's cotangent, and the autograd
    Function through both passes too.  Masked edges carry zero alpha and
    dpre."""
    S, D = 40, 30
    src, dst, mask = _graph(heads + hd, S, D, 150, 12, heavy=20)
    hs, es, ed, g = _inputs(hd, S, D, heads, hd)
    ref_dhs, ref_des, ref_ded = _reference_vjp(hs, es, ed, src, dst, mask,
                                               g, D, heads)
    dhs, des, ded, alpha, dpre = _port_passes(hs, es, ed, src, dst, mask, g,
                                              S, D)
    np.testing.assert_allclose(ded.numpy(), ref_ded, **TOL)
    np.testing.assert_allclose(dhs.numpy(), ref_dhs, **TOL)
    np.testing.assert_allclose(des.numpy(), ref_des, **TOL)
    assert (alpha.numpy()[~mask] == 0).all()
    assert (dpre.numpy()[~mask] == 0).all()
    assert (ded.numpy()[D - 1] == 0).all()      # no edge reaches it
    order, row_ptr = (_t(a) for a in dst_layout(dst, D, mask))
    ins = [_t(a).requires_grad_() for a in (hs, es, ed)]
    out = ops.GatAttention.apply(*ins, _t(src), _t(dst), order, row_ptr,
                                 tuple(_t(a) for a in dst_layout(src, S,
                                                                 mask)), D)
    for got, want in zip(torch.autograd.grad(out, ins, _t(g)),
                         (ref_dhs, ref_des, ref_ded)):
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_vjp_takes_the_slope_of_one_where_pre_is_exactly_zero():
    """``es[s] + ed[d] == 0`` exactly on some edges: the leaky ReLU's
    derivative there is 1 (``pre >= 0``), as in the reference."""
    S, D, heads, hd = 20, 12, 4, 10
    src, dst, mask = _graph(7, S, D, 80, 4)
    hs, es, ed, g = _inputs(7, S, D, heads, hd)
    ed[dst[:10], 1] = -es[src[:10], 1]
    pre = es[src] + ed[dst]
    assert ((pre == 0) & mask[:, None]).sum() >= 5
    ref = _reference_vjp(hs, es, ed, src, dst, mask, g, D, heads)
    got = _port_passes(hs, es, ed, src, dst, mask, g, S, D)[:3]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
    # the slope of 0.2 at those edges would move des and ded visibly
    order, row_ptr = (_t(a) for a in dst_layout(dst, D, mask))
    _, m, l = ops.gat_attention(_t(hs), _t(es), _t(ed), _t(src), order,
                                row_ptr, D, stats=True)
    alpha, dpre, _ = gat_fused.gat_backward_dst_plain(
        _t(g), _t(hs), _t(es), _t(ed), m, l, _t(src), order, row_ptr,
        len(src))
    at_zero = (pre == 0) & mask[:, None]
    assert np.abs(dpre.numpy()[at_zero]).max() > 1e-3


def test_k1_column_sum_matches_the_reference_segment_sum():
    """K1 with a column sums it per head over each group's listed edges,
    as the reference's segment_sum does on the masked column."""
    S, D, heads = 25, 18, 4
    src, dst, mask = _graph(3, S, D, 90, 6)
    rng = np.random.default_rng(3)
    col = rng.standard_normal((len(src), heads)).astype(np.float32)
    coef = rng.standard_normal((len(src), heads)).astype(np.float32)
    h = rng.standard_normal((D, heads * 5)).astype(np.float32)
    order_s, row_ptr_s = (_t(a) for a in dst_layout(src, S, mask))
    out, col_out = segment_sum.gather_scale_segment_sum_plain(
        _t(h), _t(dst), _t(coef), order_s, row_ptr_s, S, col=_t(col))
    want = ref_ss.segment_sum_pallas(jnp.asarray(col * mask[:, None]),
                                     jnp.asarray(src), S, interpret=True)
    np.testing.assert_allclose(col_out.numpy(), np.asarray(want), **TOL)
    alone = segment_sum.gather_scale_segment_sum_plain(
        _t(h), _t(dst), _t(coef), order_s, row_ptr_s, S)
    np.testing.assert_array_equal(out.numpy(), alone.numpy())
