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

#: the bf16 tile widths of each pair (hd 80 on the hd-96 tiles) and the
#: shared memory the source's TcTile states for the dq and dk/dv blocks
K7_BWD_TC = {(64, 64): (64, 64, 66_616, 82_984),
             (80, 80): (96, 96, 99_384, 107_560),
             (96, 96): (96, 96, 99_384, 107_560),
             (128, 128): (128, 128, 132_152, 132_136),
             (256, 256): (256, 256, 197_664, 230_440),
             (192, 128): (192, 128, 164_920, 156_712),
             (192, 192): (192, 192, 197_688, 181_288)}


#: the float32 route's tile widths, the keys a dq block walks at a time
#: and its stages, its shared memory, the queries a dk/dv block walks at a
#: time, its stages and shared memory, as the source's TileT states them
K7_BWD_TF32 = {(64, 64): (64, 64, 64, 2, 197_672, 32, 2, 115_752),
               (80, 80): (96, 96, 64, 1, 181_272, 32, 2, 156_712),
               (96, 96): (96, 96, 64, 1, 181_272, 32, 2, 156_712),
               (128, 128): (128, 128, 64, 1, 230_424, 32, 2, 197_672),
               (256, 256): (256, 256, 16, 1, 205_848, 16, 1, 214_040),
               (192, 128): (192, 128, 32, 1, 181_272, 32, 1, 197_656),
               (192, 192): (192, 192, 32, 1, 214_040, 32, 1, 230_424)}


@pytest.mark.parametrize("hd,hd_v", fa.WIDTH_PAIRS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_launch_plan_at_every_pair(hd, hd_v, dtype):
    """Both routes on the tensor cores, on the forward's tiles (hd 80 on
    the hd-96 ones), each in its own library.  bf16: 384 threads, dQ over
    (H, B, query tiles of 128) and dK/dV over (key tiles of 64, K, B),
    64-row walks, rings of 2 stages (dQ at width 256: 1), 64-byte swizzle
    at the hd-96 tiles.  float32: dQ over (query tiles of 64, H, B) with
    160 threads, dK/dV over (key tiles of 64, K, B) with 384, walks of 64,
    32 or 16 rows and one or two stages as fit, 128-byte swizzle.  Shared
    memory as the source states it, within a block's 227 KB; counters by
    dtype."""
    B, H, K, Sq, Skv = 3, 6, 2, 100, 130
    q = torch.zeros(B, H, Sq, hd, dtype=dtype)
    k = torch.zeros(B, K, Skv, hd, dtype=dtype)
    v = torch.zeros(B, K, Skv, hd_v, dtype=dtype)
    plan = fa.bwd_launch_plan(q, k, v)
    if dtype == torch.bfloat16:
        tw, twv, smem_dq, smem_dkdv = K7_BWD_TC[(hd, hd_v)]
        assert plan["route"] == "wgmma"
        assert plan["kernels"] == ("flash_bwd_dq_wgmma_kernel",
                                   "flash_bwd_dkdv_wgmma_kernel")
        assert plan["library"] == "flash_attention_bwd"
        assert plan["entries"] == ("flash_attention_bwd_dq",
                                   "flash_attention_bwd_dkdv")
        assert (plan["tile_width"], plan["tile_width_v"]) == (tw, twv)
        assert plan["swizzle"] == (128 if tw % 64 == 0 else 64)
        assert plan["threads_dq"] == plan["threads_dkdv"] == 384
        assert plan["walk_rows_dq"] == plan["walk_rows_dkdv"] == 64
        assert plan["grid_dq"] == (H, B, -(-Sq // 128))
        assert plan["grid_dkdv"] == (-(-Skv // 64), K, B)
        assert plan["stages_dq"] == (1 if hd == 256 else 2)
        assert plan["stages_dkdv"] == 2
        assert (plan["smem_dq"], plan["smem_dkdv"]) == (smem_dq, smem_dkdv)
        assert plan["counters"] == ("flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkdv")
    else:
        tw, twv, bk, sdq, smem_dq, bq, skv, smem_dkdv = K7_BWD_TF32[
            (hd, hd_v)]
        assert plan["route"] == "wgmma_tf32"
        assert plan["kernels"] == ("flash_bwd_dq_tf32_kernel",
                                   "flash_bwd_dkdv_tf32_kernel")
        assert plan["library"] == "flash_attention_bwd_tf32"
        assert plan["entries"] == ("flash_attention_bwd_tf32_dq",
                                   "flash_attention_bwd_tf32_dkdv")
        assert (plan["tile_width"], plan["tile_width_v"]) == (tw, twv)
        assert plan["swizzle"] == 128
        assert (plan["threads_dq"], plan["threads_dkdv"]) == (160, 384)
        assert plan["block_rows_dq"] == plan["block_rows_dkdv"] == 64
        assert (plan["walk_rows_dq"], plan["walk_rows_dkdv"]) == (bk, bq)
        assert (plan["stages_dq"], plan["stages_dkdv"]) == (sdq, skv)
        assert plan["grid_dq"] == (-(-Sq // 64), H, B)
        assert plan["grid_dkdv"] == (-(-Skv // 64), K, B)
        assert (plan["smem_dq"], plan["smem_dkdv"]) == (smem_dq, smem_dkdv)
        assert plan["counters"] == ("flash_attention_bwd_dq_fp32",
                                    "flash_attention_bwd_dkdv_fp32")
    assert max(plan["smem_dq"], plan["smem_dkdv"]) <= fa.SMEM_PER_BLOCK


def test_bwd_launch_plan_bf16_refuses_unaligned_views():
    """bf16 reads q, k and v through TMA maps: a view whose position
    stride is no multiple of 16 bytes is refused by name."""
    q = torch.zeros(1, 2, 8, 68, dtype=torch.bfloat16)[..., :64]
    k = torch.zeros(1, 2, 8, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="q's position stride"):
        fa.bwd_launch_plan(q, k, k)


@pytest.mark.parametrize("which", ["q", "k", "v", "do", "base"])
def test_bwd_launch_plan_float32_refuses_unaligned_views(which, monkeypatch):
    """The float32 route reads q, k, v and the output cotangent through
    TMA maps too: a view whose position stride is no multiple of 16 bytes
    (66 floats), or whose base is not 16-byte aligned, is refused by name
    before anything launches (the device check stood in for, so that
    ``_bwd_prepare`` runs on the CPU up to its launch arguments)."""
    monkeypatch.setattr(fa, "_require_cuda", lambda t, what: t.device)
    B, H, K, S, hd = 1, 2, 1, 8, 64
    t = {n: torch.zeros(B, h, S, hd) for n, h in
         (("q", H), ("k", K), ("v", K), ("do", H))}
    if which == "base":
        t["q"] = torch.zeros(B * H * S * hd + 1)[1:].reshape(B, H, S, hd)
        match = "q's base address"
    else:
        t[which] = torch.zeros(B, t[which].shape[1], S, 66)[..., :hd]
        match = f"{which}'s position stride"
    with pytest.raises(ValueError, match=match):
        fa._bwd_prepare(t["q"], t["k"], t["v"], torch.zeros(B, H, S, hd),
                        t["do"], torch.zeros(B, H, S), True, 0, None)


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


#: (C, L, H, P, G, N) -> (route, RB, runs): Mamba2-780m's and Zamba2-2.7B's
#: training shapes (2 x 1024 in chunks of 256), the reduced configs', G 2
#: and a ragged chunk
K8_BWD_PLANS = {(8, 256, 48, 64, 1, 128): ("wgmma", 6, 8),
                (8, 256, 80, 64, 1, 64): ("wgmma", 9, 9),
                (64, 16, 16, 32, 1, 16): ("cuda_core", 4, 4),
                (2, 256, 48, 64, 2, 128): ("wgmma", 2, 12),
                (3, 100, 48, 64, 1, 128): ("wgmma", 2, 24)}


@pytest.mark.parametrize("shape", sorted(K8_BWD_PLANS))
def test_ssd_bwd_launch_plan(shape):
    """The tile kernel over (64-position tiles, chunks, G runs of RB heads):
    at Mamba2's and Zamba2's training shapes at least 132 blocks (one an
    SM; 256 and 288), on the tensor cores at P 64 (one warpgroup a block)
    and on the CUDA cores at the reduced configs' (32, 16); then the scan
    over the chunks' heads and dBm (a thread per 4 elements); shared
    memory as the source's
    tc_smem / cc_smem state it; counters by dtype."""
    C, L, H, P, G, N = shape
    route, rb, runs = K8_BWD_PLANS[shape]
    for dtype, fp32 in ((torch.bfloat16, ""), (torch.float32, "_fp32")):
        x = torch.zeros(C, L, H, P, dtype=dtype)
        Bm = torch.zeros(C, L, G, N, dtype=dtype)
        plan = ssd.bwd_launch_plan(x, Bm)
        tiles = -(-L // 64)
        assert plan["route"] == route
        assert plan["kernels"] == (
            "ssd_bwd_wgmma_kernel" if route == "wgmma"
            else "ssd_bwd_cuda_core_kernel", "ssd_bwd_scan_kernel")
        assert (plan["heads_a_block"], plan["runs"]) == (rb, runs)
        assert plan["grid"] == (tiles, C, G * runs)
        assert plan["grid_scan"] == C * -(-H // 4) + C * G * -(-L * N // 512)
        assert plan["threads"] == (128 if route == "wgmma" else 256)
        assert plan["counters"] == (f"ssd_chunk_state_bwd{fp32}",
                                    f"ssd_chunk_state_bwd_scan{fp32}")
        assert plan["smem_bytes"] == ssd.bwd_smem(
            P, N, rb, dtype == torch.bfloat16) <= ssd.SMEM_PER_BLOCK
        assert plan["scratch_bytes"] == 4 * (2 * C * L * H
                                             + C * G * runs * L * N)
        if shape[:4] in ((8, 256, 48, 64), (8, 256, 80, 64)):
            assert tiles * C * G * runs >= 132


def test_ssd_bwd_launch_plan_refuses():
    """Widths outside BWD_WIDTHS, and at the tensor-core widths a Bm view
    whose position stride is no multiple of 16 bytes, are refused by
    name; a group of 400 heads splits into runs whose weights fit."""
    with pytest.raises(ValueError, match=r"\(P, N\)"):
        ssd.bwd_launch_plan(torch.zeros(1, 16, 4, 32),
                            torch.zeros(1, 16, 1, 24))
    Bm = torch.zeros(1, 256, 132, dtype=torch.bfloat16)[..., :128]
    with pytest.raises(ValueError, match="Bm's position stride"):
        ssd.bwd_launch_plan(torch.zeros(1, 256, 4, 64, dtype=torch.bfloat16),
                            Bm.unsqueeze(2))
    plan = ssd.bwd_launch_plan(torch.zeros(1, 256, 400, 64),
                               torch.zeros(1, 256, 1, 128))
    assert plan["smem_bytes"] <= ssd.SMEM_PER_BLOCK
    assert plan["heads_a_block"] * plan["runs"] >= 400


# ---------------------------------------------------------------------------
# the tensor-core designs' arithmetic, emulated in plain PyTorch
# ---------------------------------------------------------------------------

def _chip_smoke():
    """``chip_smoke.py``'s module (its bounds are what the card is held
    to), loaded from the repository's root."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bf16(a):
    """float32 values that bf16 holds exactly (bf16 inputs, as on the
    card)."""
    return torch.from_numpy(a).bfloat16()


def _k7_bf16_emulation(q, k, v, do, out, lse, causal, window, drop=None):
    """K7's bf16 tensor-core VJP in plain PyTorch: S, dP, D (from the bf16
    output the kernels read) and P in float32, P and dS rounded to bf16
    before the products that accumulate them (dV = P^T dO, dK = dS^T Q, dQ
    = dS K) with float32 sums, the gradients rounded to bf16.  ``drop``:
    a key tile (64 keys) whose pairs are dropped, a fault."""
    B, H, Sq, hd = q.shape
    K = k.shape[1]
    G = H // K
    s = 1.0 / np.sqrt(hd)
    logits, mask = fa._logits(q, k, causal, window, None)
    if drop is not None:
        mask = mask.clone()
        mask[:, 64 * drop:64 * drop + 64] = False
    p = torch.exp(logits - lse.float().reshape(B, K, G, Sq, 1))
    p = p.masked_fill(~mask, 0.0)
    dog = do.float().reshape(B, K, G, Sq, -1)
    dp = torch.einsum("bkgqh,bksh->bkgqs", dog, v.float())
    D = (dog * out.float().reshape(B, K, G, Sq, -1)).sum(-1, keepdim=True)
    ds = p * (dp - D)
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.einsum("bkgqs,bkgqh->bksh", pb, dog)
    dk = s * torch.einsum("bkgqs,bkgqh->bksh", dsb,
                          q.float().reshape(B, K, G, Sq, hd))
    dq = s * torch.einsum("bkgqs,bksh->bkgqh", dsb, k.float())
    return (dq.reshape(B, H, Sq, hd).bfloat16(), dk.bfloat16(),
            dv.bfloat16())


# (hd, hd_v, B, H, K, Sq, Skv, causal, window): a GQA group of 3, MLA's
# pair, non-causal with Sq < Skv and a window
K7_EMULATED = {"gqa_128": (128, 128, 1, 6, 2, 192, 192, True, 0),
               "mla_192_128": (192, 128, 1, 2, 2, 192, 192, True, 0),
               "window_64": (64, 64, 2, 4, 2, 150, 200, True, 90)}


@pytest.mark.parametrize("case", sorted(K7_EMULATED))
def test_k7_bf16_vjp_emulation_within_the_widened_bound(case):
    """The bf16 VJP's rounding of P and dS lies within chip_smoke.py's
    widened element bound (one bf16 ulp, the D terms, the rounding terms
    2^-8 scale sum |dS||k| for dq, 2^-8 scale sum |dS||q| for dk, 2^-8
    sum P |dO| for dv, and 1e-5 of the largest) against jax.vjp of the
    reference, at three width pairs; a VJP that drops the pairs of keys
    64-127 fails that bound in each gradient."""
    cs = _chip_smoke()
    hd, hd_v, B, H, K, Sq, Skv, causal, window = K7_EMULATED[case]
    rng = np.random.default_rng(hd + hd_v + Sq)
    q, k, v, do = (_bf16(a) for a in _k7_inputs(rng, B, H, K, Sq, Skv, hd,
                                                 hd_v))
    kw = dict(causal=causal, window=window)
    out32, lse = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                          return_lse=True, **kw)
    out = out32.bfloat16()   # the bf16 forward's output, as saved
    _, *want = _reference_vjp(*(t.float().numpy() for t in (q, k, v, do)),
                              causal, window)
    ref = [torch.from_numpy(np.array(w)) for w in want]
    d_terms = cs.k7_bwd_d_terms(torch, q, k, v, do, out, causal, window)
    r_terms = cs.k7_bwd_round_terms(torch, q, k, v, do, causal, window)
    terms = (d_terms[0] + r_terms[0], d_terms[1] + r_terms[1], r_terms[2])
    got = _k7_bf16_emulation(q, k, v, do, out, lse, causal, window)
    for g, r, t in zip(got, ref, terms):
        res = cs._grad_err(torch, g, r, bf16=True, elem_abs=t)
        assert res["ok"], res
    bad = _k7_bf16_emulation(q, k, v, do, out, lse, causal, window, drop=1)
    for g, r, t in zip(bad, ref, terms):
        assert not cs._grad_err(torch, g, r, bf16=True, elem_abs=t)["ok"]


def _tf32(t):
    """float32 rounded to the nearest TF32 (10-bit mantissa, ties away
    from zero), as ``cvt.rna.tf32.f32`` does."""
    b = t.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, passes):
    """``a @ b`` as one k-step run of the float32 route's wgmmas: each
    operand split into hi = tf32(x) and lo = tf32(x - hi), float32 sums of
    hi hi, then hi lo and lo hi (``passes`` 3), or hi hi alone (1)."""
    ah, bh = _tf32(a), _tf32(b)
    out = ah @ bh
    if passes == 3:
        out = out + ah @ _tf32(b - bh)
        out = out + _tf32(a - ah) @ bh
    return out


def _k7_fp32_emulation(q, k, v, do, out, lse, causal, window, *, passes=3):
    """K7's float32 VJP on the TF32 tensor cores in plain PyTorch, block by
    block as the kernels walk: the dq kernel's S = Q K^T and dP = dO V^T
    for each BK-key tile in order, P = exp2(S scale log2e - lse log2e)
    under the masks, dS = P (dP - D) with D = <dO, o>, dQ^T += K^T dS^T
    summed over the tiles in order; the dk/dv kernel's S^T, P^T, dP^T for
    each BQ-query tile of each head of the group in order, dS^T from P^T's
    hi + lo (as warpgroup 1 reads it), dV^T += dO^T P and dK^T += Q^T dS.
    Every product through ``_mm_tf32``; BK and BQ from the plan."""
    B, H, Sq, hd = q.shape
    K, Skv = k.shape[1], k.shape[2]
    G = H // K
    plan = fa.bwd_launch_plan(q, k, v)
    bk, bq = plan["walk_rows_dq"], plan["walk_rows_dkdv"]
    s = 1.0 / np.sqrt(hd)
    sl, l2 = s * np.log2(np.e), lse * np.log2(np.e)
    mask = fa._mask(Sq, Skv, causal, window, "cpu")
    kh = k.repeat_interleave(G, dim=1)
    vh = v.repeat_interleave(G, dim=1)
    D = (do * out).sum(-1)
    dqt = torch.zeros(B, H, hd, Sq)
    for k0 in range(0, Skv, bk):
        kt, vt = kh[:, :, k0:k0 + bk], vh[:, :, k0:k0 + bk]
        st = _mm_tf32(q, kt.transpose(-1, -2), passes)
        dp = _mm_tf32(do, vt.transpose(-1, -2), passes)
        p = torch.exp2(st * sl - l2[..., None])
        p = p.masked_fill(~mask[:, k0:k0 + bk], 0.0)
        ds = p * (dp - D[..., None])
        dqt = dqt + _mm_tf32(kt.transpose(-1, -2), ds.transpose(-1, -2),
                             passes)
    dkt = torch.zeros(B, K, hd, Skv)
    dvt = torch.zeros(B, K, v.shape[-1], Skv)
    for g in range(G):
        for i0 in range(0, Sq, bq):
            qt = q[:, g::G][:, :, i0:i0 + bq]   # heads kh G + g, kv head kh
            dot = do[:, g::G][:, :, i0:i0 + bq]
            st = _mm_tf32(k, qt.transpose(-1, -2), passes)
            pt = torch.exp2(st * sl - l2[:, g::G, None, i0:i0 + bq])
            pt = pt.masked_fill(~mask[i0:i0 + bq].T, 0.0)
            dpt = _mm_tf32(v, dot.transpose(-1, -2), passes)
            ph = _tf32(pt)
            dst = (ph + _tf32(pt - ph)) * (dpt - D[:, g::G, None, i0:i0 + bq])
            dvt = dvt + _mm_tf32(dot.transpose(-1, -2), pt.transpose(-1, -2),
                                 passes)
            dkt = dkt + _mm_tf32(qt.transpose(-1, -2), dst.transpose(-1, -2),
                                 passes)
    return (s * dqt.transpose(-1, -2), s * dkt.transpose(-1, -2),
            dvt.transpose(-1, -2))


# (hd, hd_v, B, H, K, Sq, Skv, causal, window): MLA's pair in a GQA group
# of 3, causal; a window with Sq < Skv; ragged non-causal tiles at hd 96
K7_FP32_EMULATED = {"mla_gqa3_causal": (192, 128, 1, 6, 2, 160, 160, True, 0),
                    "window_64": (64, 64, 2, 4, 2, 150, 200, True, 90),
                    "ragged_96": (96, 96, 1, 4, 2, 100, 130, False, 0)}
#: where one TF32 pass a product misses the float32 bound in every
#: gradient: Qwen2.5-14B's width, 1 x 512, 4 / 2 heads, causal (it errs by
#: 1.1e-3, 1.1e-3 and 4.7e-4 of the largest dq, dk and dv; the three passes
#: by 1.2e-6, 8.9e-7 and 1.4e-6)
K7_FP32_ONE_PASS = (128, 128, 1, 4, 2, 512, 512, True, 0)


@pytest.mark.parametrize("case", sorted(K7_FP32_EMULATED) + ["one_pass"])
def test_k7_fp32_vjp_emulation_within_the_float32_bound(case):
    """The float32 VJP's design, emulated (TF32 hi/lo splits of every
    operand, P and dS included, three passes a product, the tiles walked
    and summed in the kernels' order), lies within chip_smoke.py's float32
    bound, 1e-4 of each gradient's largest element, against jax.vjp of
    the reference, at three width pairs; the hi-only variant (one TF32
    pass a product) misses that bound in each gradient at
    K7_FP32_ONE_PASS, Qwen2.5-14B's width over 512 causal positions, while
    the three passes meet it there."""
    cs = _chip_smoke()
    hd, hd_v, B, H, K, Sq, Skv, causal, window = (
        K7_FP32_ONE_PASS if case == "one_pass" else K7_FP32_EMULATED[case])
    rng = np.random.default_rng(hd + hd_v + Sq)
    q, k, v, do = (torch.from_numpy(a) for a in _k7_inputs(
        rng, B, H, K, Sq, Skv, hd, hd_v))
    kw = dict(causal=causal, window=window)
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True, **kw)
    _, *want = _reference_vjp(q.numpy(), k.numpy(), v.numpy(), do.numpy(),
                              causal, window)
    ref = [torch.from_numpy(np.array(w)) for w in want]
    got = _k7_fp32_emulation(q, k, v, do, out, lse, causal, window)
    for g, r in zip(got, ref):
        res = cs._grad_err(torch, g, r, bf16=False)
        assert res["ok"], res
    if case == "one_pass":
        one = _k7_fp32_emulation(q, k, v, do, out, lse, causal, window,
                                 passes=1)
        assert not any(cs._grad_err(torch, g, r, bf16=False)["ok"]
                       for g, r in zip(one, ref))


def _k8_inputs(rng, C, L, H, P, G, N):
    x, Bm = _rand(rng, C, L, H, P), _rand(rng, C, L, G, N)
    dt = np.log1p(np.exp(_rand(rng, C, L, H) - 3.0)).astype(np.float32)
    A = -(1.0 + 15.0 * rng.random(H)).astype(np.float32)
    return x, dt, A, Bm, _rand(rng, C, H, P, N)


def _k8_tile_order(x, dt, A, Bm, g, rb):
    """K8's VJP in the tile kernel's and the scan kernel's order, in
    float32: per chunk, 64-position tile and run of ``rb`` heads of a
    group, u = Bm G_h^T and v = x G_h a head at a time, dx = w u, dw * w
    and dw * e, and the run's part of dBm summed over its heads in order;
    then per (chunk, head) the exclusive prefix of dw * w carried over the
    chunk's positions in order, ddt and dA's partial; dBm the runs' parts
    summed in run order."""
    C, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    runs = -(-R // rb)
    cum = torch.cumsum(dt * A, dim=1)
    e = torch.exp(cum[:, -1:, :] - cum)
    w = e * dt
    dx = torch.empty(C, L, H, P)
    qw, qe = torch.empty(C, L, H), torch.empty(C, L, H)
    part = torch.zeros(C, G, runs, L, N)
    for c in range(C):
        for l0 in range(0, L, 64):
            sl = slice(l0, min(L, l0 + 64))
            for gi in range(G):
                for run in range(runs):
                    for h in range(gi * R + run * rb,
                                   min(gi * R + (run + 1) * rb, (gi + 1) * R)):
                        u = Bm[c, sl, gi] @ g[c, h].T
                        v = x[c, sl, h] @ g[c, h]
                        dx[c, sl, h] = w[c, sl, h, None] * u
                        dw = (x[c, sl, h] * u).sum(-1)
                        qw[c, sl, h] = dw * w[c, sl, h]
                        qe[c, sl, h] = dw * e[c, sl, h]
                        part[c, gi, run, sl] += w[c, sl, h, None] * v
    ddt, dA_part = torch.empty(C, L, H), torch.zeros(C, H)
    for c in range(C):
        for h in range(H):
            pre = torch.tensor(0.0)
            for l in range(L):
                ddt[c, l, h] = qe[c, l, h] + A[h] * pre
                dA_part[c, h] += dt[c, l, h] * pre
                pre = pre + qw[c, l, h]
    dBm = torch.zeros(C, L, G, N)
    for run in range(runs):
        dBm += part[:, :, run].permute(0, 2, 1, 3)
    return dx, ddt, dA_part, dBm


@pytest.mark.parametrize("shape", [(2, 128, 12, 64, 2, 64),
                                   (2, 100, 8, 64, 1, 128),
                                   (3, 16, 16, 32, 1, 16)])
def test_k8_vjp_in_the_tile_and_scan_order(shape):
    """The new decomposition's order (heads summed into their run's dBm
    part in order, the parts summed in run order, the prefix carried over
    the position tiles) gives ssd_chunk_state_bwd_plain's gradients within
    1e-6 of each one's largest value, and jax.vjp's within the existing
    1e-5; RB is the plan's, at G 2, a ragged chunk of 100 and the reduced
    configs' widths."""
    C, L, H, P, G, N = shape
    rng = np.random.default_rng(sum(shape) + 7)
    arrays = _k8_inputs(rng, C, L, H, P, G, N)
    x, dt, A, Bm, g = (torch.from_numpy(a) for a in arrays)
    rb = ssd.bwd_launch_plan(x, Bm)["heads_a_block"]
    assert -(-(H // G) // rb) > 1   # more than one run a group
    got = _k8_tile_order(x, dt, A, Bm, g, rb)
    plain = ssd.ssd_chunk_state_bwd_plain(x, dt, A, Bm, g)
    for a, b in zip(got, plain):
        _close(a, b.numpy(), rel=1e-6)
    want = _ssd_reference_vjp(*arrays)
    for a, w in zip((got[0], got[1], got[2].sum(0), got[3]), want):
        _close(a, w)


def _bf16_split(t):
    hi = t.bfloat16().float()
    return hi, (t - hi).bfloat16().float()


def _k8_products(x, Bm, g, how):
    """u = Bm G^T and v = x G (each head against its group's Bm) with the
    operands as the tensor-core kernel reads them: G rounded once to bf16
    (``once``), G split into bf16 hi + lo with two products (``hi_lo``,
    the bf16 route: x and Bm exact in bf16), or x, Bm and G all split with
    three products, hi hi + hi lo + lo hi (``three``, the float32 route);
    float32 sums."""
    rep = x.shape[2] // Bm.shape[2]
    Bh = Bm.repeat_interleave(rep, dim=2)
    gh, gl = _bf16_split(g)
    if how == "once":
        parts = [(Bh, x, gh)]
    elif how == "hi_lo":
        parts = [(Bh, x, gh), (Bh, x, gl)]
    else:
        bh, bl = _bf16_split(Bh)
        xh, xl = _bf16_split(x)
        parts = [(bh, xh, gh), (bh, xh, gl), (bl, xl, gh)]
    u = sum(torch.einsum("clhn,chpn->clhp", b, gg) for b, _, gg in parts)
    v = sum(torch.einsum("clhp,chpn->clhn", xx, gg) for _, xx, gg in parts)
    return u, v


def _k8_from_products(x, dt, A, Bm, u, v):
    """ssd_chunk_state_bwd_plain's formulas from given u and v."""
    C, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    cum = torch.cumsum(dt * A, dim=1)
    e = torch.exp(cum[:, -1:, :] - cum)
    w = e * dt
    dw = (x * u).sum(-1)
    q = dw * w
    pre = torch.cumsum(q, dim=1) - q
    ddt = dw * e + A * pre
    dA = (dt * pre).sum(1).sum(0)
    dBm = (w[..., None] * v).reshape(C, L, G, H // G, N).sum(3)
    return w[..., None] * u, ddt, dA, dBm


def test_k8_g_split_meets_the_bound_where_one_rounding_does_not():
    """At 2 chunks of 256, 8 x 64, N 128 (bf16 x and Bm): G rounded once to
    bf16 misses phase 20(a)'s 1e-4 of the largest ddt and dA against
    jax.vjp; G split into bf16 hi + lo meets it on every gradient, and so
    does the float32 route's three-product split of float32 x, Bm and
    G."""
    C, L, H, P, G, N = 2, 256, 8, 64, 1, 128
    rng = np.random.default_rng(28)
    x32, dt, A, Bm32, g = _k8_inputs(rng, C, L, H, P, G, N)
    xb, Bmb = (torch.from_numpy(a).bfloat16().float() for a in (x32, Bm32))
    tdt, tA, tg = (torch.from_numpy(a) for a in (dt, A, g))
    want_b = _ssd_reference_vjp(xb.numpy(), dt, A, Bmb.numpy(), g)

    def rel(got, want):
        want = np.asarray(want)
        return (float(np.abs(got.numpy() - want).max())
                / float(np.abs(want).max()))

    once = _k8_from_products(xb, tdt, tA, Bmb,
                             *_k8_products(xb, Bmb, tg, "once"))
    split = _k8_from_products(xb, tdt, tA, Bmb,
                              *_k8_products(xb, Bmb, tg, "hi_lo"))
    assert rel(once[1], want_b[1]) > 1e-4 and rel(once[2], want_b[2]) > 1e-4
    for a, w in zip(split, want_b):
        assert rel(a, w) <= 1e-4
    x, Bm = torch.from_numpy(x32), torch.from_numpy(Bm32)
    want = _ssd_reference_vjp(x32, dt, A, Bm32, g)
    three = _k8_from_products(x, tdt, tA, Bm,
                              *_k8_products(x, Bm, tg, "three"))
    for a, w in zip(three, want):
        assert rel(a, w) <= 1e-4
