"""The port's plain versions of the transformer kernels, K7 (flash
attention) and K8 (the SSD chunk state), against the reference's Pallas
kernels in interpret mode and its pure-jnp oracles (``kernels/ref.py``),
on identical numpy inputs, over the reference tests' grids
(``tests/test_kernels.py``).

The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py`` (phase 8).  Tolerances are those of the
reference's own kernel tests: 2e-5 (rtol and atol) in float32, 2e-2 in
bf16 (both sides compute in float32 from the same bf16 inputs and round
once to bf16 at the end; one bf16 ulp is 2**-8 relative); 1e-4 for K8
(float32 sums over L positions in another order).

K7's bf16 route (the tensor-core kernel) cannot run here, so its
arithmetic is emulated in numpy (:func:`_emulate_wgmma_route`) and held
to the element bound phase 8 holds the kernel to on the card; its
launch plan (:func:`flash_attention.launch_plan`) is pure Python and is
tested as it is.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ssd_chunk import ssd_chunk_state_pallas
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_chunk as ssd

# K7's bf16 element bound (chip_smoke.py BF16_*): one bf16 ulp of the
# reference value for the two final roundings, 2**-8 of the reference on
# |v| for P rounded to bf16 before the PV product, 1e-5 of the largest
# value for the float32 sums' order
BF16_ULP_REL, BF16_P_REL, BF16_ATOL_REL = 2.0 ** -7, 2.0 ** -8, 1e-5

RNG = np.random.default_rng(11)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are tiny: one intra-op thread per test worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(bf16: bool):
    return dict(atol=2e-2, rtol=2e-2) if bf16 else dict(atol=2e-5, rtol=2e-5)


def _pair(a: np.ndarray, bf16: bool):
    """The same values as a jnp array and a torch tensor, in bf16 or
    float32 (bf16 rounding done once, on the numpy side's float32)."""
    j = jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16 if bf16 else torch.float32)
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("B,H,K,Sq,Skv,hd", [
    (1, 2, 2, 32, 32, 16),
    (2, 4, 2, 64, 64, 32),     # GQA G=2
    (1, 8, 1, 48, 96, 64),     # MQA, decode-ish Sq<Skv, non-multiple of 32
])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("bf16", [False, True])
def test_flash_attention_plain_matches_pallas_and_ref(B, H, K, Sq, Skv, hd,
                                                      window, bf16):
    qj, qt = _pair(RNG.normal(size=(B, H, Sq, hd)), bf16)
    kj, kt = _pair(RNG.normal(size=(B, K, Skv, hd)), bf16)
    vj, vt = _pair(RNG.normal(size=(B, K, Skv, hd)), bf16)
    got = fa.flash_attention_plain(qt, kt, vt, causal=True, window=window)
    assert got.dtype == qt.dtype
    pallas = flash_attention_pallas(qj, kj, vj, causal=True, window=window,
                                    bq=32, bk=32)
    want = ref.flash_attention(qj, kj, vj, causal=True, window=window)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(bf16))
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(bf16))


def test_flash_attention_plain_non_causal():
    qj, qt = _pair(RNG.normal(size=(1, 2, 32, 16)), False)
    kj, kt = _pair(RNG.normal(size=(1, 2, 32, 16)), False)
    vj, vt = _pair(RNG.normal(size=(1, 2, 32, 16)), False)
    got = fa.flash_attention_plain(qt, kt, vt, causal=False)
    pallas = flash_attention_pallas(qj, kj, vj, causal=False, bq=16, bk=16)
    want = ref.flash_attention(qj, kj, vj, causal=False)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(False))
    np.testing.assert_allclose(_np(got), _np(pallas), **_tol(False))


def test_flash_attention_scale_argument_and_strided_views():
    """``scale`` multiplies q in float32 (the model passes 1 on a q it
    scaled itself); (B, S, H, hd) tensors go in as (B, H, S, hd) views."""
    q = torch.from_numpy(RNG.normal(size=(2, 24, 4, 16)).astype(np.float32))
    k = torch.from_numpy(RNG.normal(size=(2, 24, 2, 16)).astype(np.float32))
    v = torch.from_numpy(RNG.normal(size=(2, 24, 2, 16)).astype(np.float32))
    dense = fa.flash_attention_plain(q.transpose(1, 2).contiguous(),
                                     k.transpose(1, 2).contiguous(),
                                     v.transpose(1, 2).contiguous(),
                                     window=5)
    views = fa.flash_attention_plain(q.transpose(1, 2) * 0.25,
                                     k.transpose(1, 2), v.transpose(1, 2),
                                     window=5, scale=1.0)
    np.testing.assert_allclose(views.numpy(), dense.numpy(), rtol=2e-6,
                               atol=2e-6)


@pytest.mark.parametrize("B,L,H,P,G,N", [
    (1, 16, 4, 8, 1, 16), (2, 32, 8, 16, 1, 24), (1, 64, 8, 32, 2, 64),
])
def test_ssd_chunk_state_plain_matches_pallas_and_ref(B, L, H, P, G, N):
    x = RNG.normal(size=(B, L, H, P)).astype(np.float32)
    dt = RNG.random((B, L, H)).astype(np.float32)
    A = -(RNG.random(H) + 0.1).astype(np.float32)
    Bm = RNG.normal(size=(B, L, G, N)).astype(np.float32)
    got = ssd.ssd_chunk_state_plain(*map(torch.from_numpy, (x, dt, A, Bm)))
    assert got.dtype == torch.float32 and got.shape == (B, H, P, N)
    pallas = ssd_chunk_state_pallas(*map(jnp.asarray, (x, dt, A, Bm)),
                                    bh=min(4, H))
    want = ref.ssd_chunk_state(*map(jnp.asarray, (x, dt, A, Bm)))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), _np(pallas), atol=1e-4,
                               rtol=1e-4)


def test_ssd_chunk_state_plain_bf16_inputs():
    """x and Bm in bf16, dt and A in float32, output float32: the plain
    version reads the bf16 values exactly, as the kernel does."""
    x = RNG.normal(size=(2, 32, 4, 8))
    Bm = RNG.normal(size=(2, 32, 2, 16))
    dt = RNG.random((2, 32, 4)).astype(np.float32)
    A = -(RNG.random(4) + 0.1).astype(np.float32)
    xj, xt = _pair(x, True)
    bj, bt = _pair(Bm, True)
    got = ssd.ssd_chunk_state_plain(xt, torch.from_numpy(dt),
                                    torch.from_numpy(A), bt)
    want = ref.ssd_chunk_state(xj, jnp.asarray(dt), jnp.asarray(A), bj)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=1e-4)


def test_dispatch_takes_plain_versions_on_cpu_and_counts_nothing():
    ops.reset_launch_counts()
    q = torch.randn(1, 2, 8, 64)
    out = ops.flash_attention(q, q, q, causal=True)
    torch.testing.assert_close(out, fa.flash_attention_plain(q, q, q))
    x = torch.randn(2, 16, 4, 8)
    dt, A, Bm = torch.rand(2, 16, 4), -torch.rand(4), torch.randn(2, 16, 1, 8)
    torch.testing.assert_close(ops.ssd_chunk_state(x, dt, A, Bm),
                               ssd.ssd_chunk_state_plain(x, dt, A, Bm))
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 0 and counts["ssd_chunk_state"] == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    q = torch.randn(1, 2, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(q, q, q)
    x = torch.randn(2, 16, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        ssd.ssd_chunk_state_cuda(x, torch.rand(2, 16, 4), -torch.rand(4),
                                 torch.randn(2, 16, 1, 8))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


# ---------------------------------------------------------------------------
# K7's bf16 route: its arithmetic, emulated, and its launch plan
# ---------------------------------------------------------------------------

def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to the nearest bf16 (ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _emulate_wgmma_route(q, k, v, *, causal, window, bk, p_bf16=True):
    """``flash_fwd_wgmma_kernel``'s arithmetic in numpy float32: blocks
    of 128 query rows; the kv tiles of ``bk`` keys from the first any row
    of the block sees to the last (the others skipped); scores scaled by
    scale * log2(e) and masked to -inf; the online softmax with exp2 from
    a running max of -1e30; P rounded to bf16 (``p_bf16``) for the PV
    product while the row sums take the unrounded P; O / max(l, 1e-30).
    Keys past Skv, which TMA fills with zeros and the kernel masks, are
    left out."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G, off = H // K, Skv - Sq
    scale_log2 = np.float32(np.log2(np.e) / np.sqrt(hd))
    out = np.zeros((B, H, Sq, hd), np.float32)
    for b in range(B):
        for h in range(H):
            kb, vb = k[b, h // G], v[b, h // G]
            for q0 in range(0, Sq, 128):
                rows = np.arange(q0, min(q0 + 128, Sq))
                qpos = rows[:, None] + off
                kv_end = min(Skv, rows[-1] + off + 1) if causal else Skv
                kv_begin = max(0, q0 + off - window + 1) if window else 0
                m = np.full(len(rows), -1e30, np.float32)
                l = np.zeros(len(rows), np.float32)
                acc = np.zeros((len(rows), hd), np.float32)
                for t in range(kv_begin // bk, -(-kv_end // bk)):
                    keys = np.arange(t * bk, min((t + 1) * bk, Skv))
                    s = (q[b, h, rows] @ kb[keys].T) * scale_log2
                    ok = np.ones(s.shape, bool)
                    if causal:
                        ok &= keys[None, :] <= qpos
                    if window:
                        ok &= keys[None, :] > qpos - window
                    s = np.where(ok, s, np.float32(-np.inf))
                    mx = np.maximum(m, s.max(axis=1))
                    alpha = np.exp2(m - mx)
                    p = np.exp2(s - mx[:, None])
                    l = l * alpha + p.sum(axis=1)
                    m = mx
                    acc = acc * alpha[:, None] + (
                        _bf16(p) if p_bf16 else p) @ vb[keys]
                out[b, h, rows] = acc / np.maximum(l, 1e-30)[:, None]
    return out


def _excess(got, want, want_abs_v=None):
    """How far the worst element of ``got`` lies outside K7's bf16 bound
    around ``want`` (without the P term when ``want_abs_v`` is None)."""
    allow = BF16_ULP_REL * np.abs(want) + BF16_ATOL_REL * np.abs(want).max()
    if want_abs_v is not None:
        allow = allow + BF16_P_REL * want_abs_v
    return float((np.abs(got - want) - allow).max())


EMULATED = [  # (B, H, K, Sq, Skv, window): ragged tiles throughout
    (1, 2, 1, 200, 200, 0),      # causal, GQA G 2
    (1, 2, 1, 300, 300, 64),     # a window: the last block skips tile 0
    (1, 2, 2, 70, 300, 0),       # Sq < Skv, queries at the end
]


@pytest.mark.parametrize("hd", [64, 96, 128, 256])
@pytest.mark.parametrize("B,H,K,Sq,Skv,window", EMULATED)
def test_wgmma_route_arithmetic_meets_the_bf16_bound(B, H, K, Sq, Skv,
                                                     window, hd):
    """The bf16 route's arithmetic (P in bf16) against the reference's
    Pallas kernel (interpret mode) and its oracle, within phase 8's bound
    2**-7 |ref| + 2**-8 ref(q, k, |v|) + 1e-5 max|ref|."""
    rng = np.random.default_rng(hd + Sq + window)
    qj, qt = _pair(rng.normal(size=(B, H, Sq, hd)), True)
    kj, kt = _pair(rng.normal(size=(B, K, Skv, hd)), True)
    vj, vt = _pair(rng.normal(size=(B, K, Skv, hd)), True)
    bk = fa.launch_plan(qt, kt, vt, qt)["block_k"]
    got = _bf16(_emulate_wgmma_route(_np(qt), _np(kt), _np(vt), causal=True,
                                     window=window, bk=bk))
    abs_v = _np(ref.flash_attention(qj.astype(jnp.float32),
                                    kj.astype(jnp.float32),
                                    jnp.abs(vj.astype(jnp.float32)),
                                    window=window))
    for want in (ref.flash_attention(qj, kj, vj, window=window),
                 flash_attention_pallas(qj, kj, vj, window=window)):
        assert _excess(got, _np(want), abs_v) <= 0.0


@pytest.mark.parametrize("hd", [64, 96, 128, 256])
def test_wgmma_route_with_float32_p_meets_the_old_bound(hd):
    """The same tiles and online softmax with P kept in float32 meet the
    bound without the P term, 2**-7 |ref| + 1e-5 max|ref|: the P term is
    the bf16 rounding of P and nothing else."""
    B, H, K, Sq, Skv, window = EMULATED[1]
    rng = np.random.default_rng(7 * hd)
    qj, qt = _pair(rng.normal(size=(B, H, Sq, hd)), True)
    kj, kt = _pair(rng.normal(size=(B, K, Skv, hd)), True)
    vj, vt = _pair(rng.normal(size=(B, K, Skv, hd)), True)
    got = _bf16(_emulate_wgmma_route(
        _np(qt), _np(kt), _np(vt), causal=True, window=window,
        bk=fa.launch_plan(qt, kt, vt, qt)["block_k"], p_bf16=False))
    want = _np(ref.flash_attention(qj, kj, vj, window=window))
    assert _excess(got, want) <= 0.0


def _model_views(B, S, H, hd, dtype=torch.bfloat16):
    """A (B, S, H, hd) tensor as the (B, H, S, hd) view the model passes."""
    return torch.zeros((B, S, H, hd), dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("hd,block_k,swizzle", [(64, 128, 128),
                                                (96, 128, 64),
                                                (128, 128, 128),
                                                (256, 64, 128)])
def test_launch_plan_routes_by_dtype_and_tiles_by_head_width(hd, block_k,
                                                             swizzle):
    q, kv = _model_views(2, 40, 8, hd), _model_views(2, 40, 2, hd)
    out = _model_views(2, 40, 8, hd)
    plan = fa.launch_plan(q, kv, kv, out)
    assert plan["route"] == "wgmma"
    assert plan["kernel"] == "flash_fwd_wgmma_kernel"
    assert plan["counter"] == "flash_attention"
    assert (plan["block_q"], plan["block_k"], plan["swizzle"]) == (
        128, block_k, swizzle)
    f32 = [t.float() for t in (q, kv, kv, out)]
    plan = fa.launch_plan(*f32)
    assert plan["route"] == "cuda_core"
    assert plan["counter"] == "flash_attention_fp32"
    assert (plan["block_q"], plan["block_k"]) == (64, 64)
    assert set(fa.launches) == {"flash_attention", "flash_attention_fp32"}


def test_launch_plan_checks_tma_alignment_and_names_the_tensor():
    hd = 96
    q, out = _model_views(2, 16, 4, hd), _model_views(2, 16, 4, hd)
    kv = _model_views(2, 16, 4, hd)
    # Phi-3's widths: the position stride is 4 * 96 * 2 = 768 bytes here
    assert fa.launch_plan(q, kv, kv, out)["route"] == "wgmma"
    # a base 2 bytes past an aligned one
    flat = torch.zeros(2 * 16 * 4 * hd + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 16, 4, hd).transpose(1, 2)
    with pytest.raises(ValueError, match="^k's base address"):
        fa.launch_plan(q, shifted, kv, out)
    # heads 100 wide cut to 96: a head stride of 200 bytes
    cut = torch.zeros((2, 16, 4, 100), dtype=torch.bfloat16)[..., :hd]
    with pytest.raises(ValueError, match="^v's head stride of 200 bytes"):
        fa.launch_plan(q, kv, cut.transpose(1, 2), out)
    # heads 104 wide cut to 96: head and position strides of 208 and 832
    # bytes, multiples of 16, accepted; a position stride of 4 * 97 * 2 =
    # 776 bytes is not
    wide = torch.zeros((2, 16, 4, 104), dtype=torch.bfloat16)[..., :hd]
    assert fa.launch_plan(q, wide.transpose(1, 2), kv, out)["route"] == \
        "wgmma"
    bad = torch.zeros((2, 16, 4 * 97), dtype=torch.bfloat16)[..., :4 * hd]
    bad = bad.as_strided((2, 4, 16, hd), (16 * 4 * 97, hd, 4 * 97, 1))
    with pytest.raises(ValueError, match="^out's position stride of 776"):
        fa.launch_plan(q, kv, kv, bad)
    # a dim of size 1 is never stepped: its stride is not checked
    one = torch.zeros((1, 16, 4, hd), dtype=torch.bfloat16)
    one = one.as_strided((1, 4, 16, hd), (3, hd, 4 * hd, 1))
    assert fa.launch_plan(one, kv[:1], kv[:1], out[:1])["route"] == "wgmma"
    # float32 takes the CUDA-core route and needs no TMA alignment
    assert fa.launch_plan(*(t.float() for t in (q, shifted, cut.transpose(
        1, 2), bad)))["route"] == "cuda_core"
