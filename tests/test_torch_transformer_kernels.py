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
