"""K8: the Mamba2 SSD per-chunk state, and its VJP.

``state[c, h, p, n] = sum_l exp(cumA_L - cumA_l) * dt_l * x[c,l,h,p] *
Bm[c,l,h // (H/G),n]`` with ``cumA`` the running sum of ``dt * A[h]`` over
the chunk's positions.

:func:`ssd_chunk_state_cuda` launches the hand-written Hopper kernel
(``csrc/ssd_chunk.cu``), the counterpart of the reference's Pallas kernel
``src/repro/kernels/ssd_chunk.py:42`` (``ssd_chunk_state_pallas``;
``pallas_call`` at ``:55``).  Three routes, by dtype and shape
(:func:`launch_plan`), at P 64, N 64 or 128 and chunks of at most 256
positions (Mamba2-780m's widths and Zamba2-2.7B's N 64) on the tensor
cores: bf16 x and Bm go to ``ssd_state_wgmma_kernel``, which folds the
decay weight into x, splits w·x into bf16 hi and lo parts (rounding it
once misses the float32 bound of 1e-4 of the largest output) and takes
both products on the same Bm; float32 goes to ``ssd_state_tf32_kernel``,
which splits w·x and Bm into TF32 hi and lo parts and takes three
products (one TF32 pass misses the same bound).  Every other width, in
either dtype (the reduced configs), goes to ``ssd_state_kernel`` on the
CUDA cores.  The routes count apart (``ssd_chunk_state``,
``ssd_chunk_state_fp32``, ``ssd_chunk_state_fp32_cuda_core``,
``ssd_chunk_state_bf16_cuda_core``).
:func:`ssd_chunk_state_plain` is the reference's oracle
(``src/repro/kernels/ref.py:40``) in PyTorch.  Both take x (C, L, H, P),
dt (C, L, H), A (H,), Bm (C, L, G, N) and return (C, H, P, N) float32.

The VJP: :class:`SSDChunkState` runs K8 and, in its backward,
:func:`ssd_chunk_state_bwd_cuda` (``csrc/ssd_chunk_bwd.cu``: one block a
(chunk, group) walking the group's heads, on the CUDA cores, no atomics)
at P 64 with N 64 or 128 (Mamba2-780m, Zamba2-2.7B) and the reduced
configs' P 32, N 16, in bf16 or float32.  It replaces no TPU kernel: the
reference trains through XLA's autodiff of its ``states`` einsum.
:func:`ssd_chunk_state_bwd_plain` is the same formulas in PyTorch.  The
raw :func:`ssd_chunk_state_cuda` stays forward-only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import SMEM_PER_BLOCK
from repro_torch.kernels.segment_sum import (_check_tma, _check_view,
                                             _refuse_grad, _require_cuda,
                                             _stream)

#: launches of the kernel wrapper (a run resets and reads it), by route:
#: the tensor cores at the tile's widths in bf16 (the served path) and in
#: float32, the CUDA cores (other widths) in float32 and in bf16
launches = {"ssd_chunk_state": 0, "ssd_chunk_state_fp32": 0,
            "ssd_chunk_state_fp32_cuda_core": 0,
            "ssd_chunk_state_bf16_cuda_core": 0,
            "ssd_chunk_state_bwd": 0, "ssd_chunk_state_bwd_fp32": 0}

#: the tensor-core route's tile: one warpgroup's m64nN product, N one of
#: TC_NS, over a chunk of at most TC_L positions
TC_P, TC_L = 64, 256
TC_NS = (64, 128)
#: heads a tensor-core block walks, at most, by N (their decay weights
#: fill the shared memory that N leaves)
W_HEADS = {64: 32, 128: 16}
#: the float32 route: a block takes TF32_NB state columns (N / TF32_NB
#: blocks a chunk), x arrives in TF32_STAGES slabs of TC_L / TF32_STAGES
#: positions, and a block walks at most TF32_HEADS heads
TF32_NB, TF32_STAGES, TF32_HEADS = 64, 4, 32


def tc_smem(N: int) -> int:
    """Dynamic shared memory of a tensor-core block at state width N: the
    1024-byte alignment slack, the chunk's Bm tile, 2 x tiles in flight
    and w*x lo, the output tile, the weights of its heads, 5 barriers
    (``TC_SMEM<N>`` in ``csrc/ssd_chunk.cu``)."""
    return (1024 + TC_L * N * 2 + 3 * TC_L * TC_P * 2 + TC_P * N * 4
            + 4 * W_HEADS[N] * TC_L + 8 * 5)


def tf32_smem() -> int:
    """Dynamic shared memory of a float32 tensor-core block (any N it
    takes): the 1024-byte alignment slack, Bm^T hi and lo for its
    TF32_NB columns, the ring of x slabs, the weights of its heads, 8
    barriers (``TF_SMEM`` in ``csrc/ssd_chunk.cu``)."""
    return (1024 + 2 * TC_L * TF32_NB * 4 + TC_L * TC_P * 4
            + 4 * TF32_HEADS * TC_L + 8 * 2 * TF32_STAGES)


def launch_plan(x: torch.Tensor, Bm: torch.Tensor) -> dict:
    """How :func:`ssd_chunk_state_cuda` launches K8 on these tensors, on
    any device (pure Python: the CPU tests rehearse it).  At P 64, N 64 or
    128 and L <= 256 both dtypes take a tensor-core route, which reads x
    (and in bf16 Bm) through TMA maps: a 16-byte-aligned base and byte
    strides in multiples of 16 along every dim longer than 1; a call that
    breaks either raises ``ValueError`` naming the tensor (float32's Bm
    is read with plain loads).  Every other call takes the CUDA-core
    route (P % 4 == 0, N % 8 == 0, any L)."""
    C, L, H, P = x.shape
    N = Bm.shape[3]
    bf16 = x.dtype == torch.bfloat16
    if P == TC_P and N in TC_NS and L <= TC_L:
        _check_tma(x, "x", ("chunk", "position", "head"))
        if not bf16:
            return {"route": "wgmma_tf32", "kernel": "ssd_state_tf32_kernel",
                    "counter": "ssd_chunk_state_fp32",
                    "tile": (TC_P, TF32_NB, TC_L), "stages": TF32_STAGES,
                    "smem_bytes": tf32_smem()}
        _check_tma(Bm, "Bm", ("chunk", "position", "group"))
        return {"route": "wgmma", "kernel": "ssd_state_wgmma_kernel",
                "counter": "ssd_chunk_state", "tile": (TC_P, N, TC_L),
                "stages": 2, "smem_bytes": tc_smem(N)}
    if P % 4 or N % 8:
        raise ValueError(f"P {P} must be a multiple of 4 and N {N} of 8")
    return {"route": "cuda_core", "kernel": "ssd_state_kernel",
            "counter": ("ssd_chunk_state_bf16_cuda_core" if bf16
                        else "ssd_chunk_state_fp32_cuda_core")}


def ssd_chunk_state_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                          Bm: torch.Tensor) -> torch.Tensor:
    """``ref.ssd_chunk_state``: the decay to the chunk's end times
    ``dt * x``, contracted with the group's ``Bm`` in float32."""
    rep = x.shape[2] // Bm.shape[2]
    Bh = Bm.repeat_interleave(rep, dim=2)
    dA = dt.float() * A
    cum = torch.cumsum(dA, dim=1)
    decay = torch.exp(cum[:, -1:, :] - cum)
    xdt = x.float() * dt[..., None].float()
    return torch.einsum("blhn,blh,blhp->bhpn", Bh.float(), decay, xdt)


def ssd_chunk_state_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         Bm: torch.Tensor) -> torch.Tensor:
    """K8 on the card (``csrc/ssd_chunk.cu``, ``ssd_chunk_state_fwd``).
    x and Bm: bf16 or float32 (one dtype), strided views allowed with the
    last dim contiguous; dt contiguous float32; A float32; the shapes and
    alignment each route takes are :func:`launch_plan`'s.  Forward only:
    an input that requires grad, with grad enabled, raises
    ``NotImplementedError`` naming :class:`SSDChunkState`
    (``_refuse_grad``)."""
    dev = _require_cuda(x, "ssd_chunk_state_cuda")
    _refuse_grad("ssd_chunk_state_cuda (K8)",
                 "kernels.ssd_chunk.SSDChunkState", x, dt, A, Bm)
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x (C, L, H, P) and Bm (C, L, G, N) must be 4-D, "
                         f"got {tuple(x.shape)} and {tuple(Bm.shape)}")
    C, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x has dtype {x.dtype}; the kernel takes bf16 or "
                        f"float32")
    _check_view(x, "x", x.dtype, dev, (C, L, H, P))
    _check_view(Bm, "Bm", x.dtype, dev, (C, L, G, N))
    _check_view(dt, "dt", torch.float32, dev, (C, L, H))
    _check_view(A, "A", torch.float32, dev, (H,))
    if not dt.is_contiguous() or not A.is_contiguous():
        raise ValueError("dt and A must be contiguous")
    if G == 0 or H % G:
        raise ValueError(f"{H} heads do not split over {G} groups")
    out = torch.empty((C, H, P, N), dtype=torch.float32, device=dev)
    if out.numel() == 0 or L == 0:
        return out.zero_()
    plan = launch_plan(x, Bm)
    strides = (ctypes.c_longlong * 6)(x.stride(0), x.stride(1), x.stride(2),
                                      Bm.stride(0), Bm.stride(1),
                                      Bm.stride(2))
    lib = build.library("ssd_chunk")
    build.check(lib.ssd_chunk_state_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        out.data_ptr(), strides, C, L, H, P, G, N,
        int(x.dtype == torch.bfloat16), int(plan["route"] != "cuda_core"),
        _stream()), "ssd_chunk_state_fwd")
    launches[plan["counter"]] += 1
    return out


# ---------------------------------------------------------------------------
# the VJP
# ---------------------------------------------------------------------------

#: the (P, N) widths the backward kernel takes: Mamba2-780m's, Zamba2's,
#: and the reduced configs'
BWD_WIDTHS = ((64, 128), (64, 64), (32, 16))
#: positions a backward tile holds, and its threads
BWD_TL, BWD_THREADS = 64, 256


def bwd_smem(P: int, N: int, R: int, L: int) -> int:
    """Dynamic shared memory of a backward block (``smem_bytes`` in
    ``csrc/ssd_chunk_bwd.cu``): the Bm and x tiles, one head's state
    cotangent (rows padded to an odd stride), the dw partials, four
    per-position rows, then the R x L running sums of dt * A and two
    floats a head."""
    fixed = (BWD_TL * (N + 1) + BWD_TL * (P + 1) + P * (N + 1)
             + BWD_TL * 16 + 4 * BWD_TL)
    return 4 * (fixed + R * L + 2 * R)


def bwd_launch_plan(x: torch.Tensor, Bm: torch.Tensor) -> dict:
    """How :func:`ssd_chunk_state_bwd_cuda` launches K8's VJP on these
    tensors, on any device (pure Python: the CPU tests rehearse it): one
    block of 256 threads a (chunk, group), walking the chunk in tiles of
    64 positions and the group's R = H / G heads inside each.  A (P, N)
    outside :data:`BWD_WIDTHS`, or R x L running sums that overflow the
    block's shared memory, raise ``ValueError``."""
    C, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (P, N) not in BWD_WIDTHS:
        raise ValueError(f"K8's backward takes (P, N) in {BWD_WIDTHS}, "
                         f"got ({P}, {N})")
    if G == 0 or H % G:
        raise ValueError(f"{H} heads do not split over {G} groups")
    smem = bwd_smem(P, N, H // G, L)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"{H // G} heads a group over chunks of {L} need "
                         f"{smem} bytes of shared memory, past "
                         f"{SMEM_PER_BLOCK}")
    return {"route": "cuda_core", "kernel": "ssd_bwd_kernel",
            "counter": ("ssd_chunk_state_bwd" if x.dtype == torch.bfloat16
                        else "ssd_chunk_state_bwd_fp32"),
            "grid": (C, G), "threads": BWD_THREADS, "tile": BWD_TL,
            "heads_a_block": H // G, "smem_bytes": smem}


def ssd_chunk_state_bwd_plain(x, dt, A, Bm, gstate):
    """The VJP of :func:`ssd_chunk_state_plain` at the state cotangent
    ``gstate`` (C, H, P, N), in float32: with ``w_l = exp(cumA_L -
    cumA_l) dt_l`` and ``u = Bm G^T``, ``dx = w u``, ``dBm = sum over the
    group's heads of w x G``, ``dw = sum_p x u``, ``ddt_j = dw_j
    exp(cumA_L - cumA_j) + A sum_{l<j} dw_l w_l`` and the chunk's part of
    ``dA``, ``sum_j dt_j sum_{l<j} dw_l w_l``.  Returns ``(dx, ddt,
    dA_part, dBm)``: dx and dBm in x's and Bm's dtypes, ddt (C, L, H) and
    the per-chunk ``dA_part`` (C, H) in float32 (their sum over chunks is
    dA)."""
    C, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    xf = x.float()
    Bh = Bm.float().repeat_interleave(rep, dim=2)
    g = gstate.float()
    cum = torch.cumsum(dt.float() * A, dim=1)
    e = torch.exp(cum[:, -1:, :] - cum)
    w = e * dt.float()
    u = torch.einsum("clhn,chpn->clhp", Bh, g)
    dw = (xf * u).sum(-1)
    dBh = w[..., None] * torch.einsum("clhp,chpn->clhn", xf, g)
    q = dw * w
    pre = torch.cumsum(q, dim=1) - q
    ddt = dw * e + A * pre
    dA_part = (dt.float() * pre).sum(1)
    dBm = dBh.reshape(C, L, G, rep, N).sum(3)
    return ((w[..., None] * u).to(x.dtype), ddt, dA_part,
            dBm.to(Bm.dtype))


def ssd_chunk_state_bwd_cuda(x, dt, A, Bm, gstate):
    """K8's VJP on the card (``csrc/ssd_chunk_bwd.cu``,
    ``ssd_chunk_state_bwd``): the inputs as :func:`ssd_chunk_state_cuda`
    takes them, ``gstate`` (C, H, P, N) float32 contiguous.  Returns
    :func:`ssd_chunk_state_bwd_plain`'s ``(dx, ddt, dA_part, dBm)``,
    dx and dBm contiguous.  The launch counts under
    :func:`bwd_launch_plan`'s counter; a refused launch raises."""
    dev = _require_cuda(x, "ssd_chunk_state_bwd_cuda")
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"x (C, L, H, P) and Bm (C, L, G, N) must be 4-D, "
                         f"got {tuple(x.shape)} and {tuple(Bm.shape)}")
    C, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x has dtype {x.dtype}; the kernel takes bf16 or "
                        f"float32")
    _check_view(x, "x", x.dtype, dev, (C, L, H, P))
    _check_view(Bm, "Bm", x.dtype, dev, (C, L, G, N))
    _check_view(dt, "dt", torch.float32, dev, (C, L, H))
    _check_view(A, "A", torch.float32, dev, (H,))
    _check_view(gstate, "gstate", torch.float32, dev, (C, H, P, N))
    for name, t in (("dt", dt), ("A", A), ("gstate", gstate)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    plan = bwd_launch_plan(x, Bm)
    dx = torch.empty((C, L, H, P), dtype=x.dtype, device=dev)
    dBm = torch.empty((C, L, G, N), dtype=x.dtype, device=dev)
    ddt = torch.empty((C, L, H), dtype=torch.float32, device=dev)
    dA_part = torch.empty((C, H), dtype=torch.float32, device=dev)
    if x.numel() == 0:
        return dx, ddt.zero_(), dA_part.zero_(), dBm.zero_()
    strides = (ctypes.c_longlong * 6)(x.stride(0), x.stride(1), x.stride(2),
                                      Bm.stride(0), Bm.stride(1),
                                      Bm.stride(2))
    lib = build.library("ssd_chunk_bwd")
    build.check(lib.ssd_chunk_state_bwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        gstate.data_ptr(), dx.data_ptr(), dBm.data_ptr(), ddt.data_ptr(),
        dA_part.data_ptr(), strides, C, L, H, P, G, N,
        int(x.dtype == torch.bfloat16), _stream()), "ssd_chunk_state_bwd")
    launches[plan["counter"]] += 1
    return dx, ddt, dA_part, dBm


class SSDChunkState(torch.autograd.Function):
    """K8 with its VJP: the forward launches K8 and saves its inputs; the
    backward launches :func:`ssd_chunk_state_bwd_cuda` and sums dA's
    per-chunk partials over the chunks (one reduction, a fixed order).
    Both look the wrappers up at call time (the CPU tests stand the plain
    versions in for them)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm):
        ctx.save_for_backward(x, dt, A, Bm)
        return ssd_chunk_state_cuda(x, dt, A, Bm)

    @staticmethod
    def backward(ctx, gstate):
        x, dt, A, Bm = ctx.saved_tensors
        dx, ddt, dA_part, dBm = ssd_chunk_state_bwd_cuda(
            x, dt, A, Bm, gstate.float().contiguous())
        return dx, ddt, dA_part.sum(0), dBm


def ssd_chunk_state_card(x, dt, A, Bm) -> torch.Tensor:
    """K8 on a CUDA tensor as ``ops`` runs it: through
    :class:`SSDChunkState` where autograd records the call, else the
    forward alone."""
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, dt, A, Bm)):
        return SSDChunkState.apply(x, dt, A, Bm)
    return ssd_chunk_state_cuda(x, dt, A, Bm)
