"""K7's and K8's VJPs: the port's plain backward formulas against JAX's
autodiff of the reference's oracles, the autograd Functions rehearsed on
the CPU, and the backward kernels' launch plans.

``flash_attention_bwd_plain`` (FlashAttention-2's backward: P recomputed
from the forward's log-sum-exp, D = <dO, o>) is held against ``jax.vjp``
of ``src/repro/kernels/ref.py:15`` (``flash_attention``) at every width
pair K7 takes, under causal, sliding-window and non-causal masks, with Sq
!= Skv and G > 1; the pair (192, 128) against ``jax.vjp`` of the
reference's ``L.attention`` (``layers.py:152``, which reads v's width
from v, as its MLA does; the oracle assumes one width).  The log-sum-exp
the plain forward returns is held against ``jax.nn.logsumexp`` of the
oracle's masked scores.  ``ssd_chunk_state_bwd_plain`` is held against
``jax.vjp`` of ``ref.py:40`` (``ssd_chunk_state``).  Tolerance: 1e-5 of
each gradient's largest element (float32 sums in another order).

The Functions (``FlashAttention``, ``SSDChunkState``) run here with the
plain versions standing in for the kernel wrappers, which they look up
at call time, against autograd through the plain forwards.  The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py`` (phase 20(a)).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models.transformer import layers as RL
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import segment_sum
from repro_torch.kernels import ssd_chunk as ssd

REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) or 1.0
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} x {scale}"


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# (B, H, K, Sq, Skv, causal, window): causal with G 2; a window; non-causal
# with Sq < Skv and G 3; causal with Sq < Skv (queries at the end)
MASKS = {"causal_g2": (2, 4, 2, 24, 24, True, 0),
         "window": (1, 2, 2, 24, 24, True, 5),
         "noncausal_g3": (1, 6, 2, 7, 19, False, 0),
         "causal_offset": (2, 4, 2, 9, 20, True, 0)}


def _k7_inputs(rng, B, H, K, Sq, Skv, hd, hd_v):
    return (_rand(rng, B, H, Sq, hd), _rand(rng, B, K, Skv, hd),
            _rand(rng, B, K, Skv, hd_v), _rand(rng, B, H, Sq, hd_v))


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _reference_vjp(q, k, v, do, causal, window):
    """``jax.vjp`` of the oracle (or, where v is narrower than q and k, of
    ``L.attention`` on the (B, S, heads, width) views, q scaled inside):
    the output and the three gradients."""
    if q.shape[-1] == v.shape[-1]:
        def f(q_, k_, v_):
            return ref.flash_attention(q_, k_, v_, causal=causal,
                                       window=window)
    else:
        off = k.shape[2] - q.shape[2]

        def f(q_, k_, v_):
            t = lambda x: jnp.swapaxes(x, 1, 2)  # noqa: E731
            return t(RL.attention(t(q_), t(k_), t(v_), causal=causal,
                                  q_offset=off, window=window))
    out, vjp = jax.vjp(f, q, k, v)
    return (out, *vjp(do))


@functools.partial(jax.jit, static_argnames=("causal", "window"))
def _reference_lse(q, k, causal, window):
    """The oracle's masked scores' log-sum-exp, (B, H, Sq)."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    qg = q.reshape(B, K, H // K, Sq, hd)
    logits = jnp.einsum("bkgqh,bksh->bkgqs", qg / np.sqrt(hd), k)
    qpos = jnp.arange(Sq)[:, None] + (Skv - Sq)
    kpos = jnp.arange(Skv)[None, :]
    mask = jnp.ones((Sq, Skv), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    logits = jnp.where(mask, logits, -1e30)
    return jax.nn.logsumexp(logits, axis=-1).reshape(B, H, Sq)


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("hd,hd_v", fa.WIDTH_PAIRS)
def test_flash_attention_bwd_plain_matches_jax_vjp(hd, hd_v, mask):
    """dq, dk, dv from the forward's output and lse, and the lse itself,
    against JAX's autodiff of the reference at every width pair."""
    B, H, K, Sq, Skv, causal, window = MASKS[mask]
    rng = np.random.default_rng(hd * 7 + hd_v + len(mask))
    q, k, v, do = _k7_inputs(rng, B, H, K, Sq, Skv, hd, hd_v)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    kw = dict(causal=causal, window=window)
    out, lse = fa.flash_attention_plain(tq, tk, tv, return_lse=True, **kw)
    got = fa.flash_attention_bwd_plain(tq, tk, tv, out, tdo, lse, **kw)
    want_out, *want = _reference_vjp(q, k, v, do, causal, window)
    _close(out, want_out)
    _close(lse, _reference_lse(q, k, causal, window))
    for g, w in zip(got, want):
        _close(g, w)


@jax.jit
def _ssd_reference_vjp(x, dt, A, Bm, g):
    return jax.vjp(ref.ssd_chunk_state, x, dt, A, Bm)[1](g)


@pytest.mark.parametrize("shape", [(4, 16, 16, 32, 1, 16),
                                   (2, 32, 4, 64, 2, 64),
                                   (3, 20, 6, 64, 3, 128)])
def test_ssd_chunk_state_bwd_plain_matches_jax_vjp(shape):
    """dx, ddt, dA (the chunks' partials summed) and dBm against JAX's
    autodiff of the reference's oracle: the reduced configs' widths, G 2
    at N 64, G 3 over a chunk of 20 at N 128; dt = softplus(N(0,1) - 3)
    and A in [-16, -1], Mamba2's ranges."""
    C, L, H, P, G, N = shape
    rng = np.random.default_rng(sum(shape))
    x, Bm = _rand(rng, C, L, H, P), _rand(rng, C, L, G, N)
    dt = np.log1p(np.exp(_rand(rng, C, L, H) - 3.0)).astype(np.float32)
    A = -(1.0 + 15.0 * rng.random(H)).astype(np.float32)
    g = _rand(rng, C, H, P, N)
    want = _ssd_reference_vjp(x, dt, A, Bm, g)
    dx, ddt, dA_part, dBm = ssd.ssd_chunk_state_bwd_plain(
        *(torch.from_numpy(a) for a in (x, dt, A, Bm, g)))
    assert dA_part.shape == (C, H)
    for got, w in zip((dx, ddt, dA_part.sum(0), dBm), want):
        _close(got, w)


# ---------------------------------------------------------------------------
# the autograd Functions, rehearsed with the plain versions as the kernels
# ---------------------------------------------------------------------------

@pytest.fixture
def card(monkeypatch):
    """``pick`` choosing the card path, whose kernel wrappers are stood in
    for by the plain versions behind the real autograd guard; returns the
    calls made, by name (``lse`` marks a forward that wrote it)."""
    calls = []

    def k7(q, k, v, *, causal=True, window=0, scale=None, return_lse=False):
        segment_sum._refuse_grad("flash_attention_cuda (K7)",
                                 "FlashAttention", q, k, v)
        calls.append("k7+lse" if return_lse else "k7")
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, scale=scale,
                                        return_lse=return_lse)

    def k7_bwd(*args, **kw):
        calls.append("k7_bwd")
        return fa.flash_attention_bwd_plain(*args, **kw)

    def k8(x, dt, A, Bm):
        segment_sum._refuse_grad("ssd_chunk_state_cuda (K8)",
                                 "SSDChunkState", x, dt, A, Bm)
        calls.append("k8")
        return ssd.ssd_chunk_state_plain(x, dt, A, Bm)

    def k8_bwd(*args):
        calls.append("k8_bwd")
        return ssd.ssd_chunk_state_bwd_plain(*args)

    monkeypatch.setattr(segment_sum, "pick", lambda card, plain, t: card)
    monkeypatch.setattr(fa, "flash_attention_cuda", k7)
    monkeypatch.setattr(fa, "flash_attention_bwd_cuda", k7_bwd)
    monkeypatch.setattr(ssd, "ssd_chunk_state_cuda", k8)
    monkeypatch.setattr(ssd, "ssd_chunk_state_bwd_cuda", k8_bwd)
    return calls


@pytest.mark.parametrize("hd,hd_v,causal,window", [
    (64, 64, True, 0), (80, 80, True, 6), (192, 128, False, 0),
    (192, 192, True, 0)])
def test_flash_attention_function_against_autograd(hd, hd_v, causal, window,
                                                   card):
    """ops.flash_attention on the card path with grad: K7 with lse once,
    its VJP once, and the gradients autograd gives through the plain
    forward; the strided (B, S, heads, width) views the model passes."""
    rng = np.random.default_rng(hd + hd_v)
    B, H, K, Sq, Skv = 2, 4, 2, 11, 17 if not causal else 11
    mk = lambda S_, n, w: torch.from_numpy(  # noqa: E731
        _rand(rng, B, S_, n, w)).transpose(1, 2)
    q, k, v = mk(Sq, H, hd), mk(Skv, K, hd), mk(Skv, K, hd_v)
    do = torch.from_numpy(_rand(rng, B, H, Sq, hd_v))
    kw = dict(causal=causal, window=window)

    def grads(fn):
        ins = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        return torch.autograd.grad(fn(*ins, **kw), ins, do)

    got = grads(ops.flash_attention)
    assert card == ["k7+lse", "k7_bwd"]
    want = grads(fa.flash_attention_plain)
    for g, w in zip(got, want):
        _close(g, w.numpy())


def test_ssd_chunk_state_function_against_autograd(card):
    """ops.ssd_chunk_state on the card path with grad: K8 once, its VJP
    once, dA summed over the chunks, the gradients autograd gives through
    the plain forward (x and Bm views of one tensor, as the model passes
    them)."""
    rng = np.random.default_rng(5)
    C, L, H, P, G, N = 3, 16, 4, 32, 2, 16
    xBC = torch.from_numpy(_rand(rng, C, L, H * P + 2 * G * N))
    x = xBC[..., :H * P].reshape(C, L, H, P)
    Bm = xBC[..., H * P:H * P + G * N].reshape(C, L, G, N)
    dt = torch.nn.functional.softplus(torch.from_numpy(_rand(rng, C, L, H)))
    A = -torch.arange(1.0, H + 1.0)
    g = torch.from_numpy(_rand(rng, C, H, P, N))

    def grads(fn):
        ins = [t.detach().clone().requires_grad_(True) for t in (x, dt, A, Bm)]
        return torch.autograd.grad(fn(*ins), ins, g)

    got = grads(ops.ssd_chunk_state)
    assert card == ["k8", "k8_bwd"]
    want = grads(ssd.ssd_chunk_state_plain)
    for a, w in zip(got, want):
        _close(a, w.numpy())


@pytest.mark.parametrize("ctx", ["no_grad", "inference_mode", "no_input"])
def test_functions_not_taken_without_a_graph(ctx, card):
    """Without a graph to record (no_grad, inference_mode, or no input
    that requires grad) the card path runs the forward alone: no lse, no
    Function."""
    q = torch.zeros(1, 2, 8, 64, requires_grad=ctx != "no_input")
    x = torch.zeros(1, 16, 2, 32, requires_grad=ctx != "no_input")
    dt, A, Bm = torch.ones(1, 16, 2), -torch.ones(2), torch.zeros(1, 16, 1, 16)
    mode = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
            "no_input": torch.enable_grad}[ctx]
    with mode():
        a = ops.flash_attention(q, q, q)
        s = ops.ssd_chunk_state(x, dt, A, Bm)
    assert card == ["k7", "k8"]
    assert a.grad_fn is None and s.grad_fn is None


# ---------------------------------------------------------------------------
# the launch plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hd,hd_v", fa.WIDTH_PAIRS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_launch_plan_at_every_pair(hd, hd_v, dtype):
    """Both backward kernels at the tensors' own widths: 64 owned rows up
    to width 128 and 32 above, walks of 32 rows, grids over (tiles,
    heads, batch), shared memory (float32 tiles, odd row strides) within
    a block's 227 KB, counters by dtype."""
    B, H, K, Sq, Skv = 3, 6, 2, 100, 130
    q = torch.zeros(B, H, Sq, hd, dtype=dtype)
    k = torch.zeros(B, K, Skv, hd, dtype=dtype)
    v = torch.zeros(B, K, Skv, hd_v, dtype=dtype)
    plan = fa.bwd_launch_plan(q, k, v)
    tb = 64 if hd <= 128 else 32
    assert plan["block_rows"] == tb and plan["walk_rows"] == 32
    assert plan["grid_dq"] == (-(-Sq // tb), H, B)
    assert plan["grid_dkdv"] == (-(-Skv // tb), K, B)
    ld = hd + 1 + hd_v + 1
    assert plan["smem_dq"] == 4 * ((tb + 32) * ld + tb * 33 + 2 * tb)
    assert plan["smem_dkdv"] == 4 * ((tb + 32) * ld + 64 * (tb + 1) + 64)
    assert max(plan["smem_dq"], plan["smem_dkdv"]) <= fa.SMEM_PER_BLOCK
    fp32 = "" if dtype == torch.bfloat16 else "_fp32"
    assert plan["counters"] == (f"flash_attention_bwd_dq{fp32}",
                                f"flash_attention_bwd_dkdv{fp32}")


def test_bwd_launch_plan_refuses_other_pairs():
    q = torch.zeros(1, 1, 8, 128)
    with pytest.raises(ValueError, match="128 with v width 64"):
        fa.bwd_launch_plan(q, q, torch.zeros(1, 1, 8, 64))
    with pytest.raises(ValueError, match="head width 48"):
        fa.bwd_launch_plan(*(torch.zeros(1, 1, 8, 48),) * 3)


@pytest.mark.parametrize("dtype,block_k,smem", [
    (torch.bfloat16, 64, 148_536), (torch.float32, 32, 222_232)])
def test_forward_plan_at_192_192(dtype, block_k, smem):
    """K7's forward at (192, 192): 64-key tiles in bf16 (two stages of
    128-key K and V tiles beside Q would pass 227 KB), 32 in float32."""
    q = torch.zeros(1, 4, 64, 192, dtype=dtype)
    plan = fa.launch_plan(q, q, q, q)
    assert plan["block_k"] == block_k and plan["smem_bytes"] == smem
    assert smem <= fa.SMEM_PER_BLOCK


@pytest.mark.parametrize("P,N,R,L", [(64, 128, 48, 256), (64, 64, 80, 256),
                                     (32, 16, 16, 16)])
def test_ssd_bwd_launch_plan(P, N, R, L):
    """One block of 256 threads a (chunk, group) at Mamba2's, Zamba2's and
    the reduced configs' widths; its shared memory holds the R x L
    running sums beside the tiles."""
    x = torch.zeros(5, L, 2 * R, P, dtype=torch.bfloat16)
    Bm = torch.zeros(5, L, 2, N, dtype=torch.bfloat16)
    plan = ssd.bwd_launch_plan(x, Bm)
    assert plan["grid"] == (5, 2) and plan["heads_a_block"] == R
    assert plan["counter"] == "ssd_chunk_state_bwd"
    assert plan["smem_bytes"] == ssd.bwd_smem(P, N, R, L) <= \
        ssd.SMEM_PER_BLOCK
    assert ssd.bwd_launch_plan(x.float(), Bm.float())["counter"] == \
        "ssd_chunk_state_bwd_fp32"


def test_ssd_bwd_launch_plan_refuses():
    with pytest.raises(ValueError, match=r"\(P, N\)"):
        ssd.bwd_launch_plan(torch.zeros(1, 16, 4, 32),
                            torch.zeros(1, 16, 1, 24))
    with pytest.raises(ValueError, match="shared memory"):
        ssd.bwd_launch_plan(torch.zeros(1, 256, 400, 64),
                            torch.zeros(1, 256, 1, 128))
