"""The port's plain aggregation kernels (K1 gather-scale-segment-sum, K2
segment-sum, K3 one-pass GAT attention) against the reference's Pallas
kernels in interpret mode and its XLA paths, on identical numpy inputs.

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
    assert ops.launch_counts() == {"gather_scale_segment_sum": 0,
                                   "segment_sum": 0, "gat_attention": 0}
