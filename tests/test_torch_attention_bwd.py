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


@pytest.mark.parametrize("hd,hd_v", fa.WIDTH_PAIRS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_launch_plan_at_every_pair(hd, hd_v, dtype):
    """bf16: the tensor-core kernels on the forward's tiles (hd 80 on the
    hd-96 ones, 64-byte swizzle there), 384 threads, dQ over (H, B, query
    tiles of 128) and dK/dV over (key tiles of 64, K, B), rings of 2
    stages (dQ at width 256: 1), shared memory as the source states it,
    within a block's 227 KB.  float32: the CUDA-core kernels at the
    tensors' own widths: 64 owned rows up to width 128 and 32 above,
    walks of 32 rows, float32 tiles with odd row strides.  Counters by
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
        assert (plan["tile_width"], plan["tile_width_v"]) == (tw, twv)
        assert plan["swizzle"] == (128 if tw % 64 == 0 else 64)
        assert plan["threads"] == 384 and plan["walk_rows"] == 64
        assert plan["grid_dq"] == (H, B, -(-Sq // 128))
        assert plan["grid_dkdv"] == (-(-Skv // 64), K, B)
        assert plan["stages_dq"] == (1 if hd == 256 else 2)
        assert plan["stages_dkdv"] == 2
        assert (plan["smem_dq"], plan["smem_dkdv"]) == (smem_dq, smem_dkdv)
        assert plan["counters"] == ("flash_attention_bwd_dq",
                                    "flash_attention_bwd_dkdv")
    else:
        tb = 64 if hd <= 128 else 32
        assert plan["route"] == "cuda_core"
        assert plan["kernels"] == ("flash_bwd_dq_kernel",
                                   "flash_bwd_dkdv_kernel")
        assert plan["block_rows"] == tb and plan["walk_rows"] == 32
        assert plan["grid_dq"] == (-(-Sq // tb), H, B)
        assert plan["grid_dkdv"] == (-(-Skv // tb), K, B)
        ld = hd + 1 + hd_v + 1
        assert plan["smem_dq"] == 4 * ((tb + 32) * ld + tb * 33 + 2 * tb)
        assert plan["smem_dkdv"] == 4 * ((tb + 32) * ld + 64 * (tb + 1) + 64)
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
