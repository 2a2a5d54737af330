"""Mamba2 (SSD, state-space duality) block [arXiv:2405.21060]; PyTorch
port of the reference's ``models/transformer/ssm.py:22-205``.

Prefill uses the chunked SSD algorithm: intra-chunk attention-like
products, per-chunk states (K8, ``repro_torch.kernels.ssd_chunk``, on the
card; its plain version on the CPU), and the recurrence across chunks (a
Python loop over chunks).  Decode is the O(1) recurrent update.

Layout follows the reference:
  projections -> z (d_inner), xBC (d_inner + 2*G*N), dt (H)
  causal depthwise conv over xBC, SiLU
  SSD over x:(B,S,H,P) with B,C:(B,S,G,N), dt:(B,S,H), A:(H,)
  gated RMSNorm (y * silu(z)), out_proj
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.launch import sharding as shd
from repro_torch.models.transformer import layers as L


def conv_dim(cfg) -> int:
    return cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state


def init_ssm(cfg, gen, dtype, device):
    """Three separate input projections ([z | xBC | dt]), as the
    reference keeps them."""
    D = cfg.d_model
    H = cfg.ssm_nheads
    din = cfg.d_inner
    cdim = conv_dim(cfg)
    return {
        "w_z": L.dense_init(gen, D, din, dtype, device),
        "w_xbc": L.dense_init(gen, D, cdim, dtype, device),
        "w_dt": L.dense_init(gen, D, H, dtype, device),
        "conv_w": L.normal(gen, (cfg.ssm_conv, cdim), device,
                           1.0 / np.sqrt(cfg.ssm_conv), dtype),
        "conv_b": torch.zeros(cdim, dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                        device=device)),
        "D": torch.ones(H, device=device),
        "dt_bias": torch.zeros(H, device=device),
        "norm": torch.ones(din, device=device),
        "out_proj": L.dense_init(gen, din, D, dtype, device),
    }


def _project(cfg, p, x):
    return x @ p["w_z"], x @ p["w_xbc"], x @ p["w_dt"]


def _causal_conv(cfg, xBC, conv_w, conv_b):
    """Depthwise causal conv along S.  xBC: (B, S, Cd).  Under sharding
    rules it runs on each device's channels (``model``) and batch
    shard, the sequence whole: a channel's conv reads only itself."""
    rules = shd.sharded(xBC)
    if rules is not None:
        c_ax = "model" if xBC.shape[-1] % rules.model_size == 0 else None
        b = rules.batch_axis
        return shd.on_shards(
            lambda x, w, bias: _causal_conv(cfg, x, w, bias),
            [(b, None, c_ax), (None, c_ax), (c_ax,)], (b, None, c_ax),
            rules)(xBC, conv_w, conv_b)
    kw = cfg.ssm_conv
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, kw - 1, 0))
    # windows: out[:, s] = sum_i w[i] * pad[:, s + i]
    out = pad[:, 0:S] * conv_w[0]
    for i in range(1, kw):
        out = out + pad[:, i:i + S] * conv_w[i]
    return F.silu(out + conv_b)


def _segsum_decay(dA_cum):
    """exp(cum_i - cum_j) masked to i >= j.  dA_cum: (..., L, H) ->
    (..., H, L, L).  The exponent is masked before the exp, as in the
    reference (the i < j entries would be exp(+large) = inf)."""
    Lc = dA_cum.shape[-2]
    diff = dA_cum[..., :, None, :] - dA_cum[..., None, :, :]   # (..., i, j, H)
    diff = torch.movedim(diff, -1, -3)                         # (..., H, i, j)
    tril = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool,
                                 device=dA_cum.device))
    diff = diff.masked_fill(~tril, -torch.inf)
    return torch.exp(diff)


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, return_final_state=False):
    """SSD scan.  x: (B,S,H,P); dt: (B,S,H) float32; A: (H,) (negative);
    Bm, Cm: (B,S,G,N).  Returns y: (B,S,H,P) [, final_state (B,H,P,N)].
    Raises ``ValueError`` when S is longer than ``chunk`` and not a
    multiple of it."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Lc = min(chunk, S)
    nc = S // Lc if Lc else 0
    if nc * Lc != S or S == 0:
        raise ValueError(f"sequence length {S} must be a multiple of the "
                         f"SSD chunk {chunk} (or at most one chunk long)")

    xc = x.reshape(Bsz, nc, Lc, H, P)
    dtc = dt.reshape(Bsz, nc, Lc, H)
    Bc = Bm.reshape(Bsz, nc, Lc, G, N)
    Cc = Cm.reshape(Bsz, nc, Lc, G, N)

    xdt = xc * dtc[..., None]                              # dt folded into x
    dA = dtc * A                                           # (B,nc,L,H)
    dA_cum = torch.cumsum(dA, dim=2)

    # --- intra-chunk (quadratic within chunk) ---
    CB = torch.einsum("bmign,bmjgn->bmgij", Cc, Bc)        # (B,nc,G,L,L)
    Mdecay = _segsum_decay(dA_cum)                         # (B,nc,H,L,L)
    CB = CB.repeat_interleave(rep, dim=2)                  # G -> H
    scores = CB * Mdecay
    y_intra = torch.einsum("bmhij,bmjhp->bmihp", scores, xdt)

    # --- per-chunk states: K8 on the (B*nc, L, H, P) view of the chunks
    # (on the card, through SSDChunkState and K8's VJP when training) ---
    states = ops.ssd_chunk_state(
        x.reshape(Bsz * nc, Lc, H, P), dt.reshape(Bsz * nc, Lc, H), A,
        Bm.reshape(Bsz * nc, Lc, G, N)).reshape(Bsz, nc, H, P, N)

    # --- inter-chunk recurrence ---
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])           # (B,nc,H)
    s = torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    prev = []
    for m in range(nc):
        prev.append(s)
        s = chunk_decay[:, m, :, None, None] * s + states[:, m].float()
    prev_states = torch.stack(prev, dim=1)                 # (B,nc,H,P,N)

    Ch = Cc.repeat_interleave(rep, dim=3)                  # (B,nc,L,H,N)
    y_inter = torch.einsum("bmlhn,bmhpn,bmlh->bmlhp", Ch,
                           prev_states.to(x.dtype),
                           torch.exp(dA_cum).to(x.dtype))
    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    if return_final_state:
        return y, s
    return y


def _ssd_sharded(rules, cfg, xs, dt, A, Bm, Cm, return_final_state):
    """:func:`ssd_chunked` under sharding rules, on each device's shards
    (``local_map``): batch over the rules' batch axis, heads over
    ``model`` where they divide (Mamba2-780m's 48, Zamba2's 80 over 16),
    the sequence whole.  B and C's groups go over ``model`` where they
    divide; else every rank takes them all and uses its heads' groups.
    The final state (B, H, P, N) keeps the heads' split."""
    H, G = xs.shape[2], Bm.shape[2]
    m, rep = rules.model_size, H // G
    b = rules.batch_axis
    hl = H // m
    h_ax = "model" if H % m == 0 and (hl % rep == 0 or rep % hl == 0) \
        else None
    g_ax = "model" if h_ax and G % m == 0 else None

    def local(x_l, dt_l, A_l, B_l, C_l):
        if h_ax and not g_ax:
            r = rules.mesh.get_local_rank("model")
            lo, hi = r * hl // rep, ((r + 1) * hl - 1) // rep + 1
            B_l, C_l = B_l[:, :, lo:hi], C_l[:, :, lo:hi]
        return ssd_chunked(x_l, dt_l, A_l, B_l, C_l, cfg.ssm_chunk,
                           return_final_state=return_final_state)

    spec_x = (b, None, h_ax, None)
    spec_g = (b, None, g_ax, None)
    outs = [spec_x, (b, h_ax, None, None)] if return_final_state else spec_x
    return shd.on_shards(local, [spec_x, (b, None, h_ax), (h_ax,), spec_g,
                                 spec_g], outs, rules)(xs, dt, A, Bm, Cm)


def ssm_forward(cfg, p, x, *, return_cache=False):
    """Full-sequence Mamba2 block.  x: (B, S, D)."""
    x = shd.gather_seq(x)
    B, S, D = x.shape
    H, P = cfg.ssm_nheads, cfg.ssm_head_dim
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    din = cfg.d_inner

    z, xBC_raw, dt = _project(cfg, p, x)
    xBC = _causal_conv(cfg, xBC_raw, p["conv_w"], p["conv_b"])
    xs = xBC[..., :din].reshape(B, S, H, P)
    Bm = xBC[..., din:din + G * N].reshape(B, S, G, N)
    Cm = xBC[..., din + G * N:].reshape(B, S, G, N)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])

    rules = shd.sharded(xs)
    if rules is not None:
        out = _ssd_sharded(rules, cfg, xs, dt, A, Bm, Cm, return_cache)
    else:
        out = ssd_chunked(xs, dt, A, Bm, Cm, cfg.ssm_chunk,
                          return_final_state=return_cache)
    if return_cache:
        y, final_state = out
    else:
        y = out
    y = y.to(x.dtype) + xs * p["D"][:, None].to(x.dtype)
    y = y.reshape(B, S, din)
    y = L.rmsnorm(y * F.silu(z), p["norm"])
    y_out = shd.scatter_seq((y @ p["out_proj"]).to(x.dtype))
    if return_cache:
        # the conv cache holds the pre-activation last kw-1 raw inputs
        conv_state = xBC_raw[:, -(cfg.ssm_conv - 1):, :]
        return y_out, (final_state, conv_state)
    return y_out


def ssm_decode(cfg, p, x, ssm_state, conv_state):
    """One-token recurrent update.

    x: (B, 1, D); ssm_state: (B, H, P, N) float32; conv_state: (B, kw-1,
    Cd).  Returns (out, ssm_state, conv_state), the states new tensors."""
    B = x.shape[0]
    din = cfg.d_inner

    z, xBC_new, dt = _project(cfg, p, x)
    window = torch.cat([conv_state, xBC_new], dim=1)          # (B, kw, Cd)
    conv_state = window[:, 1:, :]
    args = (window, p["conv_w"], p["conv_b"], dt, p["dt_bias"], p["A_log"],
            p["D"], ssm_state)
    rules = shd.sharded(ssm_state)
    if rules is None:
        y, ssm_state = _decode_core(cfg, x.dtype, *args)
    else:
        y, ssm_state = _decode_core_sharded(rules, cfg, x.dtype, *args)
    y = y.reshape(B, 1, din)
    y = L.rmsnorm(y * F.silu(z), p["norm"])
    return (y @ p["out_proj"]).to(x.dtype), ssm_state, conv_state


def _decode_core(cfg, dtype, window, conv_w, conv_b, dt, dt_bias, A_log,
                 D, ssm_state, h0: int = 0):
    """The recurrent update of heads ``h0 .. h0 + H_l - 1`` (H_l =
    ``ssm_state.shape[1]``; all heads by default) from the conv window
    (B, kw, Cd): the conv, SiLU, the heads' x, B and C, the state update
    and its readout plus the D skip.  ``dt`` (B, 1, H_l), ``dt_bias``,
    ``A_log``, ``D`` (H_l,) are the heads'.  Returns (y (B, H_l, P) in
    ``dtype``, the new state)."""
    B = window.shape[0]
    H, P = cfg.ssm_nheads, cfg.ssm_head_dim
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    din = cfg.d_inner
    xBC = torch.einsum("bkc,kc->bc", window, conv_w) + conv_b
    xBC = F.silu(xBC)

    xs = xBC[:, :din].reshape(B, H, P)
    Bm = xBC[:, din:din + G * N].reshape(B, G, N)
    Cm = xBC[:, din + G * N:].reshape(B, G, N)
    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=1)                     # (B,H,N)
    Ch = Cm.repeat_interleave(rep, dim=1)
    Hl = ssm_state.shape[1]
    if Hl != H:
        xs, Bh, Ch = (t[:, h0:h0 + Hl] for t in (xs, Bh, Ch))

    dt = F.softplus(dt[:, 0].float() + dt_bias)               # (B,H)
    A = -torch.exp(A_log)
    dA = torch.exp(dt * A)                                    # (B,H)

    ssm_state = (dA[:, :, None, None] * ssm_state
                 + torch.einsum("bh,bhp,bhn->bhpn", dt, xs.float(),
                                Bh.float()))
    y = torch.einsum("bhpn,bhn->bhp", ssm_state, Ch.float())
    return y.to(dtype) + xs * D[:, None].to(dtype), ssm_state


def _decode_core_sharded(rules, cfg, dtype, window, conv_w, conv_b, dt,
                         dt_bias, A_log, D, ssm_state):
    """:func:`_decode_core` under sharding rules, on each device's shards:
    the state's heads over ``model`` where they divide (the cache spec's),
    batch over the batch axis; the conv window and weights gathered over
    ``model`` (the channels' split does not follow the heads; (B, kw, Cd)
    of one token), each rank then taking its heads' x, B and C."""
    H = cfg.ssm_nheads
    b = rules.batch_axis
    h_ax = "model" if H % rules.model_size == 0 else None

    def local(*a):
        h0 = rules.mesh.get_local_rank("model") * a[-1].shape[1] \
            if h_ax else 0
        return _decode_core(cfg, dtype, *a, h0=h0)

    return shd.on_shards(
        local, [(b, None, None), (None, None), (None,), (b, None, h_ax),
                (h_ax,), (h_ax,), (h_ax,), (b, h_ax, None, None)],
        [(b, h_ax, None), (b, h_ax, None, None)], rules)(
        window, conv_w, conv_b, dt, dt_bias, A_log, D, ssm_state)
