"""The port's plain aggregation kernels (K1 gather-scale-segment-sum, K2
segment-sum, K3 one-pass GAT attention, K4 int8-in K1, K5 row gather, K6
edge dot) against the reference's Pallas kernels in interpret mode and
its XLA paths, on identical numpy inputs; and the autograd Functions
built on them (``gradcheck`` in float64, and against the reference's
custom VJPs).

The plain versions read the same dst-grouped layout the Hopper kernels
read, so these tests pin the layout as well as the arithmetic.  The CUDA
kernels themselves are held against the plain versions on the card by
``chip_smoke.py``.  Tolerance 1e-5 (rtol and atol): fp32 summed in a
different order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abstraction as ref_abs
from repro.kernels import gat_fused as ref_gat
from repro.kernels import segment_sum as ref_ss
from repro_torch.core import abstraction as abs_t
from repro_torch.kernels import gat_fused, ops, segment_sum
from repro_torch.kernels.segment_sum import dst_layout

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per test worker
    avoids oversubscribing the cores the other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edges(seed, S, D, E, n_pad, *, n_dup=2, masked_frac=0.2):
    """Unsorted edges with duplicates, randomly masked edges, trailing
    pad slots (src 0, dst 0, mask False, as the samplers emit them) and
    destinations that no edge reaches (the last one always)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, S, E)
    dst = rng.integers(0, max(D - 1, 1), E)
    src = np.concatenate([src, src[:n_dup]])
    dst = np.concatenate([dst, dst[:n_dup]])
    mask = rng.random(len(src)) >= masked_frac
    src = np.concatenate([src, np.zeros(n_pad, np.int64)]).astype(np.int32)
    dst = np.concatenate([dst, np.zeros(n_pad, np.int64)]).astype(np.int32)
    mask = np.concatenate([mask, np.zeros(n_pad, bool)])
    return src, dst, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _layout(dst, D, mask=None):
    order, row_ptr = dst_layout(dst, D, mask)
    return _t(order), _t(row_ptr)


CASES = [  # (S, D, E, n_pad, F)
    (40, 30, 120, 16, 1),
    (40, 30, 120, 16, 5),
    (64, 48, 200, 8, 37),
    (12, 10, 0, 0, 5),             # E = 0
    (12, 10, 0, 6, 5),             # pad slots only: every edge masked
]


def test_dst_layout_groups_valid_edges_stably():
    src, dst, mask = _edges(0, 40, 30, 120, 16)
    order, row_ptr = dst_layout(dst, 30, mask)
    assert order.dtype == np.int32 and row_ptr.dtype == np.int32
    assert row_ptr.shape == (31,) and row_ptr[0] == 0
    assert row_ptr[-1] == mask.sum()
    np.testing.assert_array_equal(np.diff(row_ptr),
                                  np.bincount(dst[mask], minlength=30))
    valid = np.flatnonzero(mask)
    np.testing.assert_array_equal(
        order, valid[np.argsort(dst[valid], kind="stable")])
    for d in range(30):               # each range holds exactly d's edges
        seg = order[row_ptr[d]:row_ptr[d + 1]]
        assert (dst[seg] == d).all() and (np.diff(seg) > 0).all()
    assert row_ptr[30] == row_ptr[29]          # last dst is empty
    full_order, full_ptr = dst_layout(dst, 30)
    assert full_ptr[-1] == len(dst)
    np.testing.assert_array_equal(full_order,
                                  np.argsort(dst, kind="stable"))


def test_device_graph_from_block_matches_reference():
    from repro.core.sampling import Block
    src, dst, mask = _edges(1, 40, 30, 120, 16)
    b = Block(np.arange(40), np.arange(30), src, dst, mask)
    ref = ref_abs.DeviceGraph.from_block(b)
    dg = abs_t.DeviceGraph.from_block(b, "cpu")
    for name in ("edge_src", "edge_dst", "edge_mask", "in_deg", "out_deg"):
        np.testing.assert_array_equal(getattr(dg, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    order, row_ptr = dst_layout(dst, 30, mask)
    np.testing.assert_array_equal(dg.order.numpy(), order)
    np.testing.assert_array_equal(dg.row_ptr.numpy(), row_ptr)
    # the kernels gather unchecked: an out-of-range index never gets there
    bad = Block(np.arange(40), np.arange(30), np.where(src == 0, 40, src),
                dst, mask)
    with pytest.raises(ValueError, match="out of range"):
        abs_t.DeviceGraph.from_block(bad, "cpu")


@pytest.mark.parametrize("S,D,E,n_pad,F", CASES)
def test_k1_plain_matches_pallas_and_xla(S, D, E, n_pad, F):
    rng = np.random.default_rng(S + E + F)
    src, dst, mask = _edges(S + F, S, D, E, n_pad)
    h = rng.standard_normal((S, F)).astype(np.float32)
    coef = (rng.standard_normal(len(src)) * mask).astype(np.float32)
    pallas = ref_ss.gather_scale_segment_sum_pallas(
        jnp.asarray(h), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(coef), D, interpret=True)
    xla = ref_abs.gather_scale_segment_sum(
        jnp.asarray(h), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(coef), D, use_kernel=False)
    order, row_ptr = _layout(dst, D, mask)
    plain = segment_sum.gather_scale_segment_sum_plain(
        _t(h), _t(src), _t(coef), order, row_ptr, D)
    via_ops = ops.gather_scale_segment_sum(_t(h), _t(src), _t(coef), order,
                                           row_ptr, D)
    # a layout over every edge, masked ones included (coef carries 0)
    via_abs = abs_t.gather_scale_segment_sum(_t(h), _t(src), _t(dst),
                                             _t(coef), D,
                                             layout=_layout(dst, D))
    assert plain.shape == (D, F)
    np.testing.assert_allclose(plain.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(xla), **TOL)
    np.testing.assert_array_equal(via_ops.numpy(), plain.numpy())
    np.testing.assert_allclose(via_abs.numpy(), np.asarray(xla), **TOL)
    assert (plain.numpy()[D - 1] == 0).all()           # empty destination


@pytest.mark.parametrize("S,D,E,n_pad,F", CASES)
def test_k2_plain_matches_pallas_and_xla(S, D, E, n_pad, F):
    rng = np.random.default_rng(7 + S + E + F)
    _, seg, mask = _edges(S + F + 1, S, D, E, n_pad)
    msgs = rng.standard_normal((len(seg), F)).astype(np.float32)
    masked = (msgs * mask[:, None]).astype(np.float32)
    pallas = ref_ss.segment_sum_pallas(jnp.asarray(masked),
                                       jnp.asarray(seg), D, interpret=True)
    xla = ref_abs.segment_sum(jnp.asarray(msgs), jnp.asarray(seg), D,
                              use_kernel=False)
    order, row_ptr = _layout(seg, D, mask)
    plain = segment_sum.segment_sum_plain(_t(masked), order, row_ptr, D)
    via_ops = ops.segment_sum(_t(masked), order, row_ptr, D)
    np.testing.assert_allclose(plain.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_array_equal(via_ops.numpy(), plain.numpy())
    # a layout over every edge, unmasked messages, vs jax.ops.segment_sum
    every = _layout(seg, D)
    full = abs_t.segment_sum(_t(msgs), _t(seg), D, layout=every)
    np.testing.assert_allclose(full.numpy(), np.asarray(xla), **TOL)
    # 1-D messages reduce as one column
    col = abs_t.segment_sum(_t(msgs[:, 0]), _t(seg), D, layout=every)
    np.testing.assert_allclose(col.numpy(), np.asarray(xla)[:, 0], **TOL)


def _gat_xla(hs, es, ed, src, dst, mask, D, heads):
    """The reference GAT layer's multi-pass XLA path (use_kernel=False)."""
    hd = hs.shape[1] // heads
    logits = jax.nn.leaky_relu(jnp.take(es, src, axis=0)
                               + jnp.take(ed, dst, axis=0), 0.2)
    alpha = ref_abs.segment_softmax(logits, dst, D, mask)
    msgs = jnp.take(hs.reshape(-1, heads, hd), src, axis=0) * alpha[..., None]
    return jax.ops.segment_sum(msgs.reshape(-1, heads * hd), dst, D)


@pytest.mark.parametrize("S,D,E,n_pad,heads,hd", [
    (40, 30, 120, 16, 4, 1),       # hd = 1: the 4-class output layer
    (40, 30, 120, 16, 4, 8),
    (50, 20, 90, 0, 2, 5),
    (12, 10, 0, 0, 4, 3),          # E = 0
    (12, 10, 0, 6, 4, 3),          # every edge masked
])
def test_k3_plain_matches_pallas_and_xla(S, D, E, n_pad, heads, hd):
    rng = np.random.default_rng(S + D + heads + hd)
    src, dst, mask = _edges(S + hd, S, D, E, n_pad)
    hs = rng.standard_normal((S, heads * hd)).astype(np.float32)
    es = rng.standard_normal((S, heads)).astype(np.float32)
    ed = rng.standard_normal((D, heads)).astype(np.float32)
    args = [jnp.asarray(a) for a in (hs, es, ed, src, dst, mask)]
    pallas = ref_gat.gat_fused_attention_pallas(*args, D, heads=heads,
                                                interpret=True)
    xla = _gat_xla(*args, D, heads)
    order, row_ptr = _layout(dst, D, mask)
    plain = gat_fused.gat_attention_plain(_t(hs), _t(es), _t(ed), _t(src),
                                          order, row_ptr, D)
    via_ops = ops.gat_attention(_t(hs), _t(es), _t(ed), _t(src), order,
                                row_ptr, D)
    assert plain.shape == (D, heads * hd)
    np.testing.assert_allclose(plain.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(xla), **TOL)
    np.testing.assert_array_equal(via_ops.numpy(), plain.numpy())
    assert (plain.numpy()[D - 1] == 0).all()           # empty destination


def test_segment_softmax_and_max_match_reference():
    rng = np.random.default_rng(3)
    _, seg, mask = _edges(3, 20, 15, 60, 5)
    logits = rng.standard_normal((len(seg), 3)).astype(np.float32)
    ref = ref_abs.segment_softmax(jnp.asarray(logits), jnp.asarray(seg), 15,
                                  jnp.asarray(mask))
    got = abs_t.segment_softmax(_t(logits), _t(seg), 15, _t(mask),
                                layout=_layout(seg, 15))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    mx_ref = ref_abs.segment_max(jnp.asarray(logits), jnp.asarray(seg), 15)
    mx = abs_t.segment_max(_t(logits), _t(seg), 15)
    np.testing.assert_array_equal(mx.numpy(), np.asarray(mx_ref))
    assert np.isneginf(mx.numpy()[14]).all()           # empty segment


def test_plain_versions_stay_differentiable():
    src, dst, mask = _edges(4, 10, 8, 24, 3)
    order, row_ptr = _layout(dst, 8, mask)
    h = torch.randn(10, 3, dtype=torch.float64, requires_grad=True)
    coef = torch.randn(len(src), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda h, c: segment_sum.gather_scale_segment_sum_plain(
            h, _t(src), c, order, row_ptr, 8), (h, coef))
    hs = torch.randn(10, 4, dtype=torch.float64, requires_grad=True)
    es = torch.randn(10, 2, dtype=torch.float64, requires_grad=True)
    ed = torch.randn(8, 2, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda a, b, c: gat_fused.gat_attention_plain(
            a, b, c, _t(src), order, row_ptr, 8), (hs, es, ed))


def test_cuda_wrappers_refuse_cpu_tensors_and_dispatch_refuses_others():
    src, dst, mask = _edges(5, 20, 15, 60, 5)
    order, row_ptr = _layout(dst, 15, mask)
    h = torch.randn(20, 4)
    coef = torch.ones(len(src))
    with pytest.raises(ValueError):
        segment_sum.gather_scale_segment_sum_cuda(h, _t(src), coef, order,
                                                  row_ptr, 15)
    with pytest.raises(ValueError):
        segment_sum.segment_sum_cuda(torch.randn(len(src), 4), order,
                                     row_ptr, 15)
    with pytest.raises(ValueError):
        gat_fused.gat_attention_cuda(torch.randn(20, 8), torch.randn(20, 2),
                                     torch.randn(15, 2), _t(src), order,
                                     row_ptr, 15)
    with pytest.raises(ValueError):
        ops.segment_sum(torch.randn(len(src), 4, device="meta"), order,
                        row_ptr, 15)
    for fn, args in [
            (segment_sum.gather_rows_cuda, (h, _t(dst), order, len(src))),
            (segment_sum.edge_dot_cuda, (h, torch.randn(15, 4), _t(src), order,
                                         row_ptr)),
            (segment_sum.gather_scale_segment_sum_q_cuda,
             (torch.zeros(20, 4, dtype=torch.uint8), torch.zeros(20, 1),
              torch.ones(20, 1), _t(src), coef, order, row_ptr, 15))]:
        with pytest.raises(ValueError):
            fn(*args)
    with pytest.raises(ValueError):
        ops.gather_rows(torch.randn(15, 4, device="meta"), _t(dst), order,
                        len(src))
    assert ops.launch_counts() == {
        "gather_scale_segment_sum": 0, "gather_scale_segment_sum_t": 0,
        "segment_sum": 0, "gather_scale_segment_sum_q": 0,
        "gather_rows": 0, "edge_dot": 0, "gat_attention": 0,
        "gat_attention_backward": 0, "flash_attention": 0, "flash_attention_fp32": 0,
        "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkdv": 0,
        "flash_attention_bwd_dq_fp32": 0, "flash_attention_bwd_dkdv_fp32": 0,
        "ssd_chunk_state": 0, "ssd_chunk_state_fp32": 0,
        "ssd_chunk_state_fp32_cuda_core": 0,
        "ssd_chunk_state_bf16_cuda_core": 0, "ssd_chunk_state_bwd": 0,
        "ssd_chunk_state_bwd_fp32": 0, "ssd_chunk_state_bwd_scan": 0,
        "ssd_chunk_state_bwd_scan_fp32": 0}


# ---------------------------------------------------------------------------
# the backward kernels (K5, K6, K1 over the src layout) and K4
# ---------------------------------------------------------------------------

def test_device_graph_src_layout_groups_the_same_edges_by_source():
    from repro.core.sampling import Block
    src, dst, mask = _edges(6, 40, 30, 120, 16)
    b = Block(np.arange(40), np.arange(30), src, dst, mask)
    assert abs_t.DeviceGraph.from_block(b, "cpu").src_layout is None
    dg = abs_t.DeviceGraph.from_block(b, "cpu", src_layout=True)
    order_s, row_ptr_s = (t.numpy() for t in dg.src_layout)
    want = dst_layout(src, 40, mask)
    np.testing.assert_array_equal(order_s, want[0])
    np.testing.assert_array_equal(row_ptr_s, want[1])
    assert sorted(order_s) == sorted(dg.order.numpy())   # same edge set


@pytest.mark.parametrize("S,D,E,n_pad,F", CASES)
def test_k5_plain_matches_pallas_on_listed_edges(S, D, E, n_pad, F):
    rng = np.random.default_rng(21 + S + E + F)
    _, seg, mask = _edges(S + F + 2, S, D, E, n_pad)
    g = rng.standard_normal((D, F)).astype(np.float32)
    pallas = np.asarray(ref_ss.gather_rows_pallas(
        jnp.asarray(g), jnp.asarray(seg), len(seg), interpret=True))
    order, _ = _layout(seg, D, mask)
    plain = segment_sum.gather_rows_plain(_t(g), _t(seg), order, len(seg))
    via_ops = ops.gather_rows(_t(g), _t(seg), order, len(seg))
    assert plain.shape == (len(seg), F)
    # exact copies of rows; unlisted (masked) edges are zero in the port
    np.testing.assert_array_equal(plain.numpy()[mask], pallas[mask])
    assert (plain.numpy()[~mask] == 0).all()
    np.testing.assert_array_equal(via_ops.numpy(), plain.numpy())


@pytest.mark.parametrize("S,D,E,n_pad,F", CASES)
def test_k6_plain_matches_pallas_on_listed_edges(S, D, E, n_pad, F):
    rng = np.random.default_rng(31 + S + E + F)
    src, dst, mask = _edges(S + F + 3, S, D, E, n_pad)
    h = rng.standard_normal((S, F)).astype(np.float32)
    gout = rng.standard_normal((D, F)).astype(np.float32)
    pallas = np.asarray(ref_ss._edge_dot(
        jnp.asarray(h), jnp.asarray(gout), jnp.asarray(src), jnp.asarray(dst),
        ref_ss.DEFAULT_BE, ref_ss._pick_bf(F), True))
    order, row_ptr = _layout(dst, D, mask)
    plain = segment_sum.edge_dot_plain(_t(h), _t(gout), _t(src), order,
                                       row_ptr)
    via_ops = ops.edge_dot(_t(h), _t(gout), _t(src), order, row_ptr)
    assert plain.shape == (len(src), 1)
    np.testing.assert_allclose(plain.numpy()[mask, 0], pallas[mask], **TOL)
    assert (plain.numpy()[~mask] == 0).all()
    np.testing.assert_array_equal(via_ops.numpy(), plain.numpy())


@pytest.mark.parametrize("heads,hd", [(4, 1), (4, 8), (2, 5)])
def test_multi_head_k1_and_k6_are_per_head_reference_calls(heads, hd):
    """The GAT backward's one-launch forms: K1 with an (E, heads)
    coefficient and K6 with ``heads``, against the reference's per-head
    ``_fused_impl`` and ``_edge_dot`` (what ``_gat_bwd`` calls)."""
    S, D, F = 40, 30, heads * hd
    rng = np.random.default_rng(heads * 10 + hd)
    src, dst, mask = _edges(heads + hd, S, D, 120, 16)
    g = rng.standard_normal((D, F)).astype(np.float32)
    hs = rng.standard_normal((S, F)).astype(np.float32)
    alpha = (rng.random((len(src), heads)) * mask[:, None]).astype(np.float32)
    order_s, row_ptr_s = _layout(src, S, mask)
    order, row_ptr = _layout(dst, D, mask)
    dhs = segment_sum.gather_scale_segment_sum_plain(
        _t(g), _t(dst), _t(alpha), order_s, row_ptr_s, S).numpy()
    dal = segment_sum.edge_dot_plain(_t(hs), _t(g), _t(src), order, row_ptr,
                                     heads).numpy()
    bf = ref_ss._pick_bf(hd)
    for k in range(heads):
        cols = slice(k * hd, (k + 1) * hd)
        want = ref_ss._fused_impl(jnp.asarray(g[:, cols]), jnp.asarray(dst),
                                  jnp.asarray(src), jnp.asarray(alpha[:, k]),
                                  S, ref_ss.DEFAULT_BE, ref_ss.DEFAULT_BN,
                                  bf, True)
        np.testing.assert_allclose(dhs[:, cols], np.asarray(want), **TOL)
        want = ref_ss._edge_dot(jnp.asarray(hs[:, cols]),
                                jnp.asarray(g[:, cols]), jnp.asarray(src),
                                jnp.asarray(dst), ref_ss.DEFAULT_BE, bf, True)
        np.testing.assert_allclose(dal[mask, k], np.asarray(want)[mask],
                                   **TOL)


def _quantize_rows(h):
    """The reference tests' per-row affine uint8 codec (normal range)."""
    mn = h.min(axis=1, keepdims=True)
    scale = np.maximum((h.max(axis=1, keepdims=True) - mn) / 255.0, 1e-12)
    q = np.rint((h - mn) / scale).astype(np.uint8)
    return q, mn.astype(np.float32), scale.astype(np.float32)


@pytest.mark.parametrize("S,D,E,n_pad,F", CASES[1:] + [(50, 40, 200, 4, 33)])
def test_k4_plain_matches_pallas_and_decode_then_fp32(S, D, E, n_pad, F):
    rng = np.random.default_rng(41 + S + E + F)
    src, dst, mask = _edges(S + F + 4, S, D, E, n_pad)
    h = rng.standard_normal((S, F)).astype(np.float32)
    q, mn, scale = _quantize_rows(h)
    coef = (rng.standard_normal(len(src)) * mask).astype(np.float32)
    pallas = ref_ss.gather_scale_segment_sum_q_pallas(
        jnp.asarray(q), jnp.asarray(mn), jnp.asarray(scale),
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(coef), D,
        interpret=True)
    decoded = mn + q.astype(np.float32) * scale
    want = ref_ss.gather_scale_segment_sum_pallas(
        jnp.asarray(decoded), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(coef), D, interpret=True)
    order, row_ptr = _layout(dst, D, mask)
    plain = segment_sum.gather_scale_segment_sum_q_plain(
        _t(q), _t(mn), _t(scale), _t(src), _t(coef), order, row_ptr, D)
    via_ops = ops.gather_scale_segment_sum_q(
        _t(q), _t(mn), _t(scale), _t(src), _t(coef), order, row_ptr, D)
    np.testing.assert_allclose(plain.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(via_ops.numpy(), plain.numpy())
    # within the codec's bound of the true fp32 aggregation (fp64 truth):
    # |err| <= sum over the listed edges of |coef| * scale_src / 2
    v = mask
    truth = np.zeros((D, F))
    np.add.at(truth, dst[v], h[src[v]].astype(np.float64) * coef[v, None])
    bound = np.zeros(D)
    np.add.at(bound, dst[v], np.abs(coef[v]) * (scale[src[v], 0] / 2 + 1e-7))
    err = np.abs(plain.numpy() - truth).max(axis=1, initial=0.0)
    assert (err <= bound + 1e-5).all(), (err - bound).max()


# ---------------------------------------------------------------------------
# the autograd Functions
# ---------------------------------------------------------------------------

def _f64(a, grad=True):
    return torch.from_numpy(np.asarray(a, np.float64)).requires_grad_(grad)


@pytest.mark.parametrize("n_pad", [0, 6])
def test_gradcheck_k1_function(n_pad):
    src, dst, mask = _edges(50 + n_pad, 10, 8, 24, n_pad)
    rng = np.random.default_rng(n_pad)
    h = _f64(rng.standard_normal((10, 3)))
    coef = _f64(rng.standard_normal(len(src)) * mask)
    order, row_ptr = _layout(dst, 8, mask)
    src_layout = _layout(src, 10, mask)
    assert torch.autograd.gradcheck(
        lambda h, c: ops.GatherScaleSegmentSum.apply(
            h, _t(src), _t(dst), c, order, row_ptr, src_layout, 8),
        (h, coef))
    with pytest.raises(ValueError, match="src_layout=True"):
        ops.GatherScaleSegmentSum.apply(h, _t(src), _t(dst), coef, order,
                                        row_ptr, None, 8)


def test_gradcheck_k2_and_scatter_gather_functions():
    src, dst, mask = _edges(60, 10, 8, 24, 5)
    rng = np.random.default_rng(1)
    msgs = _f64(rng.standard_normal((len(src), 3)))
    order, row_ptr = _layout(dst, 8, mask)
    assert torch.autograd.gradcheck(
        lambda m: ops.SegmentSum.apply(m, _t(dst), order, row_ptr, 8),
        (msgs,))
    x = _f64(rng.standard_normal((10, 3)))
    src_layout = _layout(src, 10, mask)
    assert torch.autograd.gradcheck(
        lambda x: ops.GatherRows.apply(x, _t(src), order, src_layout), (x,))


def test_scatter_gather_walks_the_idx_layout_with_the_same_rows(
        monkeypatch):
    """Given the layout grouped by idx, GatherRows hands K5 that layout's
    order (the same listed edges, so each row of x is read once, in
    turn); the rows it writes are the plain gather's, bit for bit."""
    src, dst, mask = _edges(61, 40, 30, 120, 16)
    x = _t(np.random.default_rng(2).standard_normal((40, 7)
                                                    ).astype(np.float32))
    order, _ = _layout(dst, 30, mask)
    src_layout = _layout(src, 40, mask)
    walked = []
    gather = ops.gather_rows

    def spy(g, seg, walk, num_edges):
        walked.append(walk)
        return gather(g, seg, walk, num_edges)

    monkeypatch.setattr(ops, "gather_rows", spy)
    with_layout = ops.GatherRows.apply(x, _t(src), order, src_layout)
    without = ops.GatherRows.apply(x, _t(src), order, None)
    assert walked[0] is src_layout[0] and walked[1] is order
    want = segment_sum.gather_rows_plain(x, _t(src), order, len(src))
    np.testing.assert_array_equal(with_layout.numpy(), want.numpy())
    np.testing.assert_array_equal(without.numpy(), want.numpy())


@pytest.mark.parametrize("reads_dst", [False, True])
def test_saga_layer_matches_reference(reads_dst):
    """The SAGA-NN step and its gradient against the reference's
    ``saga_layer``; a message that does not read the destination rows
    gets None for them (the port does not gather them)."""
    from repro.core.sampling import Block
    src, dst, mask = _edges(80, 40, 30, 120, 16)
    b = Block(np.arange(40), np.arange(30), src, dst, mask)
    rng = np.random.default_rng(80)
    x = rng.standard_normal((40, 6)).astype(np.float32)
    ct = rng.standard_normal((30, 6)).astype(np.float32)

    def edge(s, d, _):
        return s * d if reads_dst else s

    def vertex(agg, xd):
        return agg + 2.0 * xd

    ref_g = ref_abs.DeviceGraph.from_block(b)
    want, vjp = jax.vjp(lambda xj: ref_abs.saga_layer(
        ref_g, xj, xj[:30], apply_edge=edge, apply_vertex=vertex),
        jnp.asarray(x))
    (dx_want,) = vjp(jnp.asarray(ct))
    seen = []
    dg = abs_t.DeviceGraph.from_block(b, "cpu", src_layout=True)
    xt = _t(x).requires_grad_(True)
    got = abs_t.saga_layer(
        dg, xt, xt[:30], apply_vertex=vertex, reads_dst=reads_dst,
        apply_edge=lambda s, d, e: seen.append(d) or edge(s, d, e))
    got.backward(_t(ct))
    assert (seen[0] is not None) == reads_dst
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_want), **TOL)


@pytest.mark.parametrize("heads,hd", [(2, 3), (4, 1)])
def test_gradcheck_k3_function(heads, hd):
    src, dst, mask = _edges(70 + hd, 10, 8, 30, 5)
    rng = np.random.default_rng(heads + hd)
    hs = _f64(rng.standard_normal((10, heads * hd)))
    es = _f64(rng.standard_normal((10, heads)))
    ed = _f64(rng.standard_normal((8, heads)))
    order, row_ptr = _layout(dst, 8, mask)
    src_layout = _layout(src, 10, mask)
    assert torch.autograd.gradcheck(
        lambda a, b, c: ops.GatAttention.apply(
            a, b, c, _t(src), _t(dst), order, row_ptr, src_layout, 8),
        (hs, es, ed))


def test_functions_match_the_reference_custom_vjps():
    """Cotangents of the K1 and K3 Functions against ``jax.vjp`` through
    the reference's Pallas custom VJPs (interpret mode), on the listed
    edges; masked edges carry zero coefficient cotangent in the port."""
    S, D, F, heads = 40, 30, 8, 4
    rng = np.random.default_rng(9)
    src, dst, mask = _edges(9, S, D, 120, 16)
    h = rng.standard_normal((S, F)).astype(np.float32)
    coef = (rng.standard_normal(len(src)) * mask).astype(np.float32)
    es = rng.standard_normal((S, heads)).astype(np.float32)
    ed = rng.standard_normal((D, heads)).astype(np.float32)
    g = rng.standard_normal((D, F)).astype(np.float32)
    order, row_ptr = _layout(dst, D, mask)
    src_layout = _layout(src, S, mask)

    _, vjp = jax.vjp(lambda h, c: ref_ss.gather_scale_segment_sum_pallas(
        h, jnp.asarray(src), jnp.asarray(dst), c, D, interpret=True),
        jnp.asarray(h), jnp.asarray(coef))
    ref_dh, ref_dc = vjp(jnp.asarray(g))
    ht, ct = _t(h).requires_grad_(), _t(coef).requires_grad_()
    out = ops.GatherScaleSegmentSum.apply(ht, _t(src), _t(dst), ct, order,
                                          row_ptr, src_layout, D)
    dh, dc = torch.autograd.grad(out, (ht, ct), _t(g))
    np.testing.assert_allclose(dh.numpy(), np.asarray(ref_dh), **TOL)
    np.testing.assert_allclose(dc.numpy()[mask], np.asarray(ref_dc)[mask],
                               **TOL)
    assert (dc.numpy()[~mask] == 0).all()

    _, vjp = jax.vjp(lambda a, b, c: ref_gat.gat_fused_attention_pallas(
        a, b, c, jnp.asarray(src), jnp.asarray(dst), jnp.asarray(mask), D,
        heads=heads, interpret=True), jnp.asarray(h), jnp.asarray(es),
        jnp.asarray(ed))
    refs = vjp(jnp.asarray(g))
    ins = [_t(a).requires_grad_() for a in (h, es, ed)]
    out = ops.GatAttention.apply(*ins, _t(src), _t(dst), order, row_ptr,
                                 src_layout, D)
    for got, want in zip(torch.autograd.grad(out, ins, _t(g)), refs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
