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

The tensor-core routes cannot run here, so their arithmetic is
emulated in numpy and held to the bounds phase 8 holds the kernels to on
the card: K7's bf16 route (:func:`_emulate_wgmma_route`) to its element
bound, K7's float32 route (:func:`_emulate_tf32_route`: TF32 hi/lo
splits, three products each) and K8's bf16 route
(:func:`_emulate_k8_route`: w·x split into bf16 hi and lo) to 1e-4 of the
largest reference value, which one unsplit pass misses.  The launch plans
(:func:`flash_attention.launch_plan`, :func:`ssd_chunk.launch_plan`) are
pure Python and are tested as they are.
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
    (2, 4, 2, 64, 64, 80),     # Zamba2-2.7B's head width, G 2
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


def _tf32(x: np.ndarray) -> np.ndarray:
    """float32 rounded to the nearest TF32 (10-bit mantissa, ties away
    from zero), as ``cvt.rna.tf32.f32`` does, as float32."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split3(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a @ b`` as the float32 route takes it: each operand split into
    TF32 hi and lo (the lo the remainder of that hi), three products."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bh + ah @ bl + al @ bh


def _emulate_route(q, k, v, *, causal, window, bq, bk, qk, pv, tile=0):
    """The tensor-core K7 routes' arithmetic in numpy float32: blocks of
    ``bq`` query rows; the kv tiles of ``bk`` keys from the first any row
    of the block sees to the last (the others skipped); scores ``qk(q,
    k)`` scaled by scale * log2(e) and masked to -inf; the online softmax
    with exp2 from a running max of -1e30; ``pv(p, v)`` for the PV
    product while the row sums take P as it is; O / max(l, 1e-30).  Keys
    past Skv, which TMA fills with zeros and the kernel masks, are left
    out.  A ``tile`` wider than hd (hd 80 on the hd-96 tiles) pads q, k
    and v with the zero columns TMA fills in and cuts the output back to
    hd, as the TMA store clips it; the scale stays 1/sqrt(hd)."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G, off = H // K, Skv - Sq
    scale_log2 = np.float32(np.log2(np.e) / np.sqrt(hd))
    if tile > hd:
        pad = [(0, 0)] * 3 + [(0, tile - hd)]
        q, k, v = (np.pad(a, pad) for a in (q, k, v))
    out = np.zeros(q.shape, np.float32)
    for b in range(B):
        for h in range(H):
            kb, vb = k[b, h // G], v[b, h // G]
            for q0 in range(0, Sq, bq):
                rows = np.arange(q0, min(q0 + bq, Sq))
                qpos = rows[:, None] + off
                kv_end = min(Skv, rows[-1] + off + 1) if causal else Skv
                kv_begin = max(0, q0 + off - window + 1) if window else 0
                m = np.full(len(rows), -1e30, np.float32)
                l = np.zeros(len(rows), np.float32)
                acc = np.zeros((len(rows), q.shape[-1]), np.float32)
                for t in range(kv_begin // bk, -(-kv_end // bk)):
                    keys = np.arange(t * bk, min((t + 1) * bk, Skv))
                    s = qk(q[b, h, rows], kb[keys]) * scale_log2
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
                    acc = acc * alpha[:, None] + pv(p, vb[keys])
                out[b, h, rows] = acc / np.maximum(l, 1e-30)[:, None]
    return out[..., :hd]


def _emulate_wgmma_route(q, k, v, *, causal, window, bk, tile=0,
                         p_bf16=True):
    """``flash_fwd_wgmma_kernel``: blocks of 128 query rows, Q·Kᵀ of bf16
    values exact in float32, P rounded to bf16 (``p_bf16``) for the PV
    product."""
    return _emulate_route(
        q, k, v, causal=causal, window=window, bq=128, bk=bk, tile=tile,
        qk=lambda a, b: a @ b.T,
        pv=lambda p, vv: (_bf16(p) if p_bf16 else p) @ vv)


def _emulate_tf32_route(q, k, v, *, causal, window, bk, tile=0,
                        split=True):
    """``flash_fwd_tf32_kernel``: blocks of 64 query rows, both products
    as three TF32 products of split operands, or (``split=False``) as one
    product of the operands rounded to TF32."""
    prod = _split3 if split else (lambda a, b: _tf32(a) @ _tf32(b))
    return _emulate_route(q, k, v, causal=causal, window=window, bq=64,
                          bk=bk, tile=tile, qk=lambda a, b: prod(a, b.T),
                          pv=prod)


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


@pytest.mark.parametrize("hd", [64, 80, 96, 128, 256])
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
    plan = fa.launch_plan(qt, kt, vt, qt)
    got = _bf16(_emulate_wgmma_route(_np(qt), _np(kt), _np(vt), causal=True,
                                     window=window, bk=plan["block_k"],
                                     tile=plan["tile_width"]))
    abs_v = _np(ref.flash_attention(qj.astype(jnp.float32),
                                    kj.astype(jnp.float32),
                                    jnp.abs(vj.astype(jnp.float32)),
                                    window=window))
    for want in (ref.flash_attention(qj, kj, vj, window=window),
                 flash_attention_pallas(qj, kj, vj, window=window)):
        assert _excess(got, _np(want), abs_v) <= 0.0


@pytest.mark.parametrize("hd", [64, 80, 96, 128, 256])
def test_wgmma_route_with_float32_p_meets_the_old_bound(hd):
    """The same tiles and online softmax with P kept in float32 meet the
    bound without the P term, 2**-7 |ref| + 1e-5 max|ref|: the P term is
    the bf16 rounding of P and nothing else."""
    B, H, K, Sq, Skv, window = EMULATED[1]
    rng = np.random.default_rng(7 * hd)
    qj, qt = _pair(rng.normal(size=(B, H, Sq, hd)), True)
    kj, kt = _pair(rng.normal(size=(B, K, Skv, hd)), True)
    vj, vt = _pair(rng.normal(size=(B, K, Skv, hd)), True)
    plan = fa.launch_plan(qt, kt, vt, qt)
    got = _bf16(_emulate_wgmma_route(
        _np(qt), _np(kt), _np(vt), causal=True, window=window,
        bk=plan["block_k"], tile=plan["tile_width"], p_bf16=False))
    want = _np(ref.flash_attention(qj, kj, vj, window=window))
    assert _excess(got, want) <= 0.0


def _rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("hd", [64, 80, 96, 128, 256])
@pytest.mark.parametrize("B,H,K,Sq,Skv,window", EMULATED)
def test_tf32_route_arithmetic_meets_the_float32_bound(B, H, K, Sq, Skv,
                                                       window, hd):
    """The float32 route's arithmetic (TF32 hi/lo splits, three products
    each for Q·Kᵀ and P·V, 64-row blocks, its key tiles) against the
    reference's Pallas kernel (interpret mode) and its oracle in float32,
    within phase 8's bound of 1e-4 of the largest value."""
    rng = np.random.default_rng(3 * hd + Sq + window)
    qj, qt = _pair(rng.normal(size=(B, H, Sq, hd)), False)
    kj, kt = _pair(rng.normal(size=(B, K, Skv, hd)), False)
    vj, vt = _pair(rng.normal(size=(B, K, Skv, hd)), False)
    plan = fa.launch_plan(qt, kt, vt, qt)
    got = _emulate_tf32_route(_np(qt), _np(kt), _np(vt), causal=True,
                              window=window, bk=plan["block_k"],
                              tile=plan["tile_width"])
    for want in (ref.flash_attention(qj, kj, vj, window=window),
                 flash_attention_pallas(qj, kj, vj, window=window)):
        assert _rel_err(got, _np(want)) <= 1e-4


def test_one_tf32_pass_misses_the_float32_bound():
    """Why the float32 route splits: at hd 96, S 1024, 8 heads, causal,
    one TF32 product per operand pair misses 1e-4 of the largest value
    (5.0e-4 of it), and the three products of the splits keep to it by
    orders of magnitude (3.6e-7)."""
    rng = np.random.default_rng(96)
    q, k, v = (rng.normal(size=(1, 8, 1024, 96)).astype(np.float32)
               for _ in range(3))
    want = _np(ref.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v)))
    one = _emulate_tf32_route(q, k, v, causal=True, window=0, bk=64,
                              split=False)
    split = _emulate_tf32_route(q, k, v, causal=True, window=0, bk=64)
    assert _rel_err(one, want) > 1e-4
    assert _rel_err(split, want) <= 1e-5


def _emulate_k8_route(x, dt, A, Bm, *, split=True):
    """``ssd_state_wgmma_kernel``'s arithmetic in numpy float32: the
    prefix sum of dt·A in order, w = exp(cum_last - cum) · dt, w·x in
    float32 split into bf16 hi and lo (or, ``split=False``, rounded once
    to bf16), each part times the group's Bm (exact in bf16) summed over
    the chunk's positions in float32."""
    C, L, H, P = x.shape
    rep = H // Bm.shape[2]
    cum = np.cumsum(dt * A, axis=1, dtype=np.float32)
    w = np.exp(cum[:, -1:, :] - cum) * dt
    wx = w[..., None] * x
    hi = _bf16(wx)
    Bh = np.repeat(Bm, rep, axis=2)
    out = np.einsum("clhp,clhn->chpn", hi, Bh)
    if split:
        out = out + np.einsum("clhp,clhn->chpn", _bf16(wx - hi), Bh)
    return out


def _k8_inputs(rng, C, L, H, P, G, N):
    """bf16 x and Bm (as the served path passes them), float32 dt =
    softplus(normal) and A = -(1 .. H), as phase 8 makes them."""
    xj, xt = _pair(rng.normal(size=(C, L, H, P)), True)
    bj, bt = _pair(rng.normal(size=(C, L, G, N)), True)
    dt = np.log1p(np.exp(rng.normal(size=(C, L, H)))).astype(np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32)
    return (xj, xt), (bj, bt), dt, A


def _check_k8_route(G, L, N, seed):
    rng = np.random.default_rng(seed)
    (xj, xt), (bj, bt), dt, A = _k8_inputs(rng, 2, L, 4, 64, G, N)
    got = _emulate_k8_route(_np(xt), dt, A, _np(bt))
    args = (xj.astype(jnp.float32), jnp.asarray(dt), jnp.asarray(A),
            bj.astype(jnp.float32))
    for want in (ref.ssd_chunk_state(*args),
                 ssd_chunk_state_pallas(*args, bh=4)):
        assert _rel_err(got, _np(want)) <= 1e-4


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("L", [100, 256])
def test_k8_bf16_route_arithmetic_meets_the_float32_bound(G, L):
    """K8's bf16 route (w·x split into bf16 hi + lo, Mamba2's P 64 and N
    128) against the reference's Pallas kernel (interpret mode) and its
    oracle, within phase 8's bound of 1e-4 of the largest value, at G 1
    and 2, a full chunk and a ragged one."""
    _check_k8_route(G, L, 128, 10 * G + L)


@pytest.mark.parametrize("G", [1, 2])
def test_k8_bf16_route_at_n64_meets_the_float32_bound(G):
    """The same at N 64, the route's other width (Zamba2-2.7B's state),
    on a ragged chunk."""
    _check_k8_route(G, 100, 64, 64 + G)


def test_one_bf16_rounding_of_wx_misses_the_float32_bound():
    """Why K8's bf16 route splits: at Mamba2's P 64 and N 128 (4 chunks
    of 256, 8 heads, G 1), w·x rounded once to bf16 misses 1e-4 of the
    largest value (2.2e-3 of it); its hi + lo split keeps to it (1.1e-5)."""
    rng = np.random.default_rng(780)
    (xj, xt), (bj, bt), dt, A = _k8_inputs(rng, 4, 256, 8, 64, 1, 128)
    want = _np(ref.ssd_chunk_state(xj.astype(jnp.float32), jnp.asarray(dt),
                                   jnp.asarray(A), bj.astype(jnp.float32)))
    x, Bm = _np(xt), _np(bt)
    assert _rel_err(_emulate_k8_route(x, dt, A, Bm, split=False), want) > \
        1e-4
    assert _rel_err(_emulate_k8_route(x, dt, A, Bm), want) <= 2e-5


def _emulate_k8_tf32_route(x, dt, A, Bm, *, split=True):
    """``ssd_state_tf32_kernel``'s arithmetic in numpy: the weights as
    the bf16 route forms them, A = (w·x)ᵀ formed in float32, A and Bm each
    split into TF32 hi and lo = tf32(value - hi) (or, ``split=False``,
    rounded once to TF32), and the three products Ah·Bh + Ah·Bl + Al·Bh
    summed over the chunk's positions in k-steps of 8, each k-step's
    products (exact in float64) added to the float32 sum in turn."""
    C, L, H, P = x.shape
    rep = H // Bm.shape[2]
    cum = np.cumsum(dt * A, axis=1, dtype=np.float32)
    w = np.exp(cum[:, -1:, :] - cum) * dt
    wx = (w[..., None] * x).astype(np.float32)
    Bh = np.repeat(Bm, rep, axis=2)
    ah, bh = _tf32(wx), _tf32(Bh)
    pairs = ([(ah, bh), (ah, _tf32(Bh - bh)), (_tf32(wx - ah), bh)]
             if split else [(ah, bh)])
    out = np.zeros((C, H, P, Bm.shape[3]), np.float32)
    for l0 in range(0, L, 8):
        for a, b in pairs:
            step = np.einsum("clhp,clhn->chpn", a[:, l0:l0 + 8].astype(
                np.float64), b[:, l0:l0 + 8].astype(np.float64))
            out = (out + step).astype(np.float32)
    return out


def _k8_f32_inputs(rng, C, L, H, P, G, N):
    """float32 x and Bm, dt = softplus(normal) and A = -(1 .. H), as
    phase 8 makes them."""
    x = rng.normal(size=(C, L, H, P)).astype(np.float32)
    Bm = rng.normal(size=(C, L, G, N)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(C, L, H)))).astype(np.float32)
    A = -np.arange(1, H + 1, dtype=np.float32)
    return x, dt, A, Bm


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("N", [64, 128])
def test_k8_tf32_route_arithmetic_meets_the_float32_bound(G, N):
    """K8's float32 route (TF32 hi/lo splits of w·x and Bm, three
    products, P 64, 2 chunks of 256, 4 heads) against the reference's
    Pallas kernel (interpret mode) and its oracle, within phase 8's bound
    of 1e-4 of the largest value, at N 64 and 128 and G 1 and 2."""
    rng = np.random.default_rng(32 * N + G)
    x, dt, A, Bm = _k8_f32_inputs(rng, 2, 256, 4, 64, G, N)
    got = _emulate_k8_tf32_route(x, dt, A, Bm)
    args = tuple(map(jnp.asarray, (x, dt, A, Bm)))
    for want in (ref.ssd_chunk_state(*args),
                 ssd_chunk_state_pallas(*args, bh=4)):
        assert _rel_err(got, _np(want)) <= 1e-4


def test_k8_tf32_route_on_a_ragged_chunk():
    """A chunk of 100 positions: the kernel's k-steps past L add zeros."""
    rng = np.random.default_rng(100)
    x, dt, A, Bm = _k8_f32_inputs(rng, 3, 100, 8, 64, 2, 64)
    want = _np(ssd_chunk_state_pallas(*map(jnp.asarray, (x, dt, A, Bm)),
                                      bh=4))
    assert _rel_err(_emulate_k8_tf32_route(x, dt, A, Bm), want) <= 1e-4


def test_one_tf32_pass_misses_k8s_float32_bound():
    """Why K8's float32 route splits: at Mamba2's P 64 and N 128 (4
    chunks of 256, 8 heads, G 1), one TF32 product misses 1e-4 of the
    largest value (4.1e-4 of it); the three products of the splits keep
    to it (1.4e-5, as the bf16 route's split does; against the exact
    product of the same float32 w·x they err by 1.2e-7: the float32
    prefix sums of dt·A, not the split, set the floor)."""
    rng = np.random.default_rng(781)
    x, dt, A, Bm = _k8_f32_inputs(rng, 4, 256, 8, 64, 1, 128)
    want = _np(ssd_chunk_state_pallas(*map(jnp.asarray, (x, dt, A, Bm)),
                                      bh=4))
    one = _rel_err(_emulate_k8_tf32_route(x, dt, A, Bm, split=False), want)
    three = _rel_err(_emulate_k8_tf32_route(x, dt, A, Bm), want)
    assert one > 1e-4
    assert three <= 2e-5


def _model_views(B, S, H, hd, dtype=torch.bfloat16):
    """A (B, S, H, hd) tensor as the (B, H, S, hd) view the model passes."""
    return torch.zeros((B, S, H, hd), dtype=dtype).transpose(1, 2)


@pytest.mark.parametrize("hd,block_k,swizzle", [(64, 128, 128),
                                                (80, 128, 64),
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
    assert plan["smem_bytes"] <= fa.SMEM_PER_BLOCK
    # float32: the TF32 split route, its key tile shrinking with hd so
    # that the splits fit in a block's shared memory
    f32 = [t.float() for t in (q, kv, kv, out)]
    plan = fa.launch_plan(*f32)
    assert plan["route"] == "wgmma_tf32"
    assert plan["kernel"] == "flash_fwd_tf32_kernel"
    assert plan["counter"] == "flash_attention_fp32"
    assert (plan["block_q"], plan["block_k"], plan["stages"],
            plan["swizzle"]) == (64, 16 if hd == 256 else 32, 1, 128)
    # Q hi and lo, K (hi in place) and K lo, raw V, V^T hi and lo, at the
    # tile's width (96 at hd 80): two blocks share an SM at hd 64, 80 and
    # 96, the heads the served models use
    tile = plan["tile_width"]
    assert tile == (96 if hd == 80 else hd)
    assert plan["smem_bytes"] == (1024 + 2 * 64 * tile * 4
                                  + 5 * plan["block_k"] * tile * 4 + 24)
    assert plan["smem_bytes"] <= fa.SMEM_PER_BLOCK
    assert plan["blocks_per_sm"] == (2 if hd <= 96 else 1)
    # the forward's two routes, and the VJP's two kernels in each dtype
    assert set(fa.launches) == {"flash_attention", "flash_attention_fp32",
                                "flash_attention_bwd_dq",
                                "flash_attention_bwd_dkdv",
                                "flash_attention_bwd_dq_fp32",
                                "flash_attention_bwd_dkdv_fp32"}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_launch_plan_runs_hd_80_on_the_hd_96_tiles_and_refuses_72(dtype):
    """Zamba2-2.7B's (8, 1024, 32, 80) views: rows of 160 bytes in bf16
    and 320 in float32 pass TMA's checks, and the plan is the hd-96 one
    (same tiles, swizzle and shared memory); a width no kernel instance
    takes raises before anything is launched."""
    views = [_model_views(8, 1024, 32, 80, dtype) for _ in range(4)]
    assert views[0].stride(1) * views[0].element_size() == \
        80 * views[0].element_size()
    plan = fa.launch_plan(*views)
    wide = fa.launch_plan(*[_model_views(8, 1024, 32, 96, dtype)
                            for _ in range(4)])
    assert plan == wide and plan["tile_width"] == 96
    if dtype == torch.bfloat16:
        assert plan["smem_bytes"] == 1024 + 128 * 96 * 2 + 4 * 128 * 96 * 2 \
            + 8 * 7
    for hd in (72, 48):
        bad = [_model_views(2, 16, 4, hd, dtype) for _ in range(4)]
        with pytest.raises(ValueError, match=f"head width {hd} not in"):
            fa.launch_plan(*bad)


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
    # float32 reads through TMA too: the same checks, in its byte strides
    qf, kvf, outf = q.float(), kv.float(), out.float()
    assert fa.launch_plan(qf, kvf, kvf, outf)["route"] == "wgmma_tf32"
    flat32 = torch.zeros(2 * 16 * 4 * hd + 1)
    with pytest.raises(ValueError, match="^k's base address"):
        fa.launch_plan(qf, flat32[1:].view(2, 16, 4, hd).transpose(1, 2),
                       kvf, outf)
    # heads 98 wide cut to 96: a head stride of 392 bytes
    cut32 = torch.zeros((2, 16, 4, 98))[..., :hd]
    with pytest.raises(ValueError, match="^v's head stride of 392 bytes"):
        fa.launch_plan(qf, kvf, cut32.transpose(1, 2), outf)
    # heads 100 wide cut to 96: strides of 400 and 1600 bytes, accepted
    wide32 = torch.zeros((2, 16, 4, 100))[..., :hd]
    assert fa.launch_plan(qf, wide32.transpose(1, 2), kvf,
                          outf)["route"] == "wgmma_tf32"


def _conv_views(C, L, H, P, G, N, dtype=torch.bfloat16, pad=0):
    """x and Bm as the model passes them: slices of one (C, L, conv_dim)
    tensor, conv_dim = H P + 2 G N (+ ``pad`` elements)."""
    xBC = torch.zeros((C, L, H * P + 2 * G * N + pad), dtype=dtype)
    x = xBC[..., :H * P].reshape(C, L, H, P)
    Bm = xBC[..., H * P:H * P + G * N].reshape(C, L, G, N)
    return x, Bm


@pytest.mark.parametrize("G", [1, 2])
def test_k8_launch_plan_routes_by_dtype(G):
    """bf16 takes the tensor-core route at Mamba2's views (a conv row of
    3 328 or 3 584 bf16, a multiple of 16 bytes) and at Zamba2-2.7B's N
    64; float32 at the same widths its TF32 route, off them the CUDA-core
    route; the four routes count apart."""
    x, Bm = _conv_views(32, 256, 48, 64, G, 128)
    plan = ssd.launch_plan(x, Bm)
    assert (plan["route"], plan["kernel"], plan["counter"]) == (
        "wgmma", "ssd_state_wgmma_kernel", "ssd_chunk_state")
    assert plan["tile"] == (64, 128, 256) and plan["stages"] == 2
    assert plan["smem_bytes"] == ssd.tc_smem(128) <= fa.SMEM_PER_BLOCK
    plan64 = ssd.launch_plan(*_conv_views(32, 256, 80, 64, G, 64))
    assert (plan64["route"], plan64["tile"]) == ("wgmma", (64, 64, 256))
    assert plan64["smem_bytes"] == ssd.tc_smem(64) < plan["smem_bytes"]
    for H, N in ((48, 128), (80, 64)):
        plan32 = ssd.launch_plan(*_conv_views(32, 256, H, 64, G, N,
                                              torch.float32))
        assert plan32 == {
            "route": "wgmma_tf32", "kernel": "ssd_state_tf32_kernel",
            "counter": "ssd_chunk_state_fp32", "tile": (64, 64, 256),
            "stages": 4, "smem_bytes": ssd.tf32_smem()}
    x32, B32 = _conv_views(6, 100, 8, 32, G, 24, torch.float32)
    assert ssd.launch_plan(x32, B32) == {
        "route": "cuda_core", "kernel": "ssd_state_kernel",
        "counter": "ssd_chunk_state_fp32_cuda_core"}
    # the forward's four routes, and the VJP's two kernels in each dtype
    assert set(ssd.launches) == {"ssd_chunk_state", "ssd_chunk_state_fp32",
                                 "ssd_chunk_state_fp32_cuda_core",
                                 "ssd_chunk_state_bf16_cuda_core",
                                 "ssd_chunk_state_bwd",
                                 "ssd_chunk_state_bwd_fp32",
                                 "ssd_chunk_state_bwd_scan",
                                 "ssd_chunk_state_bwd_scan_fp32"}


def test_k8_tf32_route_states_its_shared_memory():
    """The float32 route's block: Bm^T hi and lo for 64 columns (128 KB),
    a ring of four 64-position x slabs (64 KB), the weights of 32 heads,
    the alignment slack and 8 barriers: 230 464 bytes, within a block's
    232 448, the number the source states beside ``TF_SMEM``."""
    assert ssd.tf32_smem() == 1024 + 131072 + 65536 + 32768 + 64 == 230464
    assert ssd.tf32_smem() <= fa.SMEM_PER_BLOCK
    from repro_torch.kernels import build
    text = (build.CSRC / "ssd_chunk.cu").read_text()
    assert "+ 64 = 230464 bytes" in text
    for name, value in (("TF_NB", ssd.TF32_NB), ("TF_HEADS", ssd.TF32_HEADS)):
        assert f"constexpr int {name} = {value};" in text


@pytest.mark.parametrize("shape", [(2, 64, 4, 64, 1, 128),
                                   (2, 100, 8, 64, 2, 64),
                                   (3, 7, 48, 64, 1, 128)])
def test_k8_tf32_route_takes_ragged_chunks_and_groups(shape):
    plan = ssd.launch_plan(*_conv_views(*shape, torch.float32))
    assert plan["route"] == "wgmma_tf32"


def test_k8_float32_off_the_tile_takes_the_cuda_core_route():
    """P 32, N 24, N 96 and a chunk of 300 in float32: the CUDA-core
    kernel, counted under its own name."""
    for shape in ((6, 100, 8, 32, 2, 24), (2, 64, 4, 64, 1, 96),
                  (2, 300, 4, 64, 1, 128), (2, 16, 8, 32, 2, 16)):
        assert ssd.launch_plan(*_conv_views(*shape, torch.float32)) == {
            "route": "cuda_core", "kernel": "ssd_state_kernel",
            "counter": "ssd_chunk_state_fp32_cuda_core"}


def test_k8_tf32_route_checks_x_for_tma_and_names_it():
    # a conv row of 4 * 64 + 2 * 128 + 1 floats: a position stride of
    # 2 052 bytes
    x, Bm = _conv_views(2, 64, 4, 64, 1, 128, torch.float32, pad=1)
    with pytest.raises(ValueError, match="^x's position stride of 2052"):
        ssd.launch_plan(x, Bm)
    # x 4 bytes past an aligned base
    flat = torch.zeros(2 * 64 * 256 + 8)
    shifted = flat[1:1 + 2 * 64 * 256].view(2, 64, 4, 64)
    _, Bm = _conv_views(2, 64, 4, 64, 1, 128, torch.float32)
    with pytest.raises(ValueError, match="^x's base address"):
        ssd.launch_plan(shifted, Bm)
    # float32's Bm is read with plain loads: a Bm 4 bytes off still runs
    x, _ = _conv_views(2, 64, 4, 64, 1, 128, torch.float32)
    Bm_off = flat[1:1 + 2 * 64 * 128].view(2, 64, 1, 128)
    assert ssd.launch_plan(x, Bm_off)["route"] == "wgmma_tf32"


def test_k8_launch_plan_checks_shapes_and_tma_alignment():
    # bf16 off the tensor-core tile (P 64, N 64 or 128, at most 256
    # positions) takes the CUDA-core route, counted apart: the reduced
    # configs' widths, P 32, N 96, a chunk of 300
    for shape in ((2, 16, 8, 32, 2, 16), (2, 64, 4, 32, 1, 128),
                  (2, 64, 4, 64, 1, 96), (2, 300, 4, 64, 1, 128)):
        assert ssd.launch_plan(*_conv_views(*shape)) == {
            "route": "cuda_core", "kernel": "ssd_state_kernel",
            "counter": "ssd_chunk_state_bf16_cuda_core"}
    with pytest.raises(ValueError, match="N 20 of 8"):
        ssd.launch_plan(*_conv_views(2, 16, 8, 32, 1, 20))
    # a conv row of 4 * 64 + 2 * 128 + 3 elements: a position stride of
    # 1 030 bytes
    x, Bm = _conv_views(2, 64, 4, 64, 1, 128, pad=3)
    with pytest.raises(ValueError, match="^x's position stride of 1030"):
        ssd.launch_plan(x, Bm)
    # Bm 2 bytes past an aligned base
    x, _ = _conv_views(2, 64, 4, 64, 1, 128)
    flat = torch.zeros(2 * 64 * 256 + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + 2 * 64 * 128].view(2, 64, 1, 128)
    with pytest.raises(ValueError, match="^Bm's base address"):
        ssd.launch_plan(x, shifted)
    # float32 off the tensor-core tile goes to the CUDA-core route's own
    # checks
    with pytest.raises(ValueError, match="P 30 must be a multiple of 4"):
        ssd.launch_plan(*_conv_views(2, 64, 4, 30, 1, 128, torch.float32))
