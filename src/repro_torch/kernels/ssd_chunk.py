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
:func:`ssd_chunk_state_bwd_cuda` (``csrc/ssd_chunk_bwd.cu``, no atomics):
a tile kernel, one block a (64-position tile, chunk, run of a group's
heads), on the tensor cores at P 64 with N 64 or 128 (Mamba2-780m,
Zamba2-2.7B; G's float32 split into bf16 hi and lo, x and Bm too in
float32) and on the CUDA cores at the reduced configs' P 32, N 16; then a
scan kernel for ddt, dA's per-chunk partials and dBm's sum over the runs,
in bf16 or float32 (:func:`bwd_launch_plan`).  It replaces no TPU kernel: the
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
#: float32, the CUDA cores (other widths) in float32 and in bf16; the
#: backward's tile and scan kernels in each dtype
launches = {"ssd_chunk_state": 0, "ssd_chunk_state_fp32": 0,
            "ssd_chunk_state_fp32_cuda_core": 0,
            "ssd_chunk_state_bf16_cuda_core": 0,
            "ssd_chunk_state_bwd": 0, "ssd_chunk_state_bwd_fp32": 0,
            "ssd_chunk_state_bwd_scan": 0,
            "ssd_chunk_state_bwd_scan_fp32": 0}

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

#: the (P, N) widths the backward takes: Mamba2-780m's and Zamba2-2.7B's
#: on the tensor cores (BWD_TC_WIDTHS), the reduced configs' on the CUDA
#: cores
BWD_WIDTHS = ((64, 128), (64, 64), (32, 16))
BWD_TC_WIDTHS = ((64, 128), (64, 64))
#: positions a backward tile block holds
BWD_TL = 64
#: threads of a tile block on the tensor cores (one warpgroup) and on the
#: CUDA cores (4 a position), and of a scan block (4 warps)
BWD_TC_THREADS, BWD_CC_THREADS, BWD_SCAN_THREADS = 128, 256, 128
#: the tile blocks a call aims for: two an SM of an H100's 132
BWD_BLOCKS = 2 * 132


def bwd_smem(P: int, N: int, RB: int, bf16: bool) -> int:
    """Dynamic shared memory of a backward tile block with RB heads
    (``tc_smem`` / ``cc_smem`` in ``csrc/ssd_chunk_bwd.cu``).  Tensor
    cores: the 1024-byte alignment slack, the Bm tile in bf16 (hi and lo
    in float32), G_h's bf16 hi and lo, the next head's G_h in float32 as
    it arrives, then w and e of the RB heads.  CUDA cores: the Bm, x and
    G_h tiles in float32, rows padded to an odd stride, then w and e."""
    if (P, N) in BWD_TC_WIDTHS:
        chunk = BWD_TL * 128
        return (1024 + (1 if bf16 else 2) * (N // 64) * chunk
                + 2 * (N // 64) * chunk + 4 * P * N + 2 * 4 * BWD_TL * RB)
    return 4 * (BWD_TL * (N + 1) + BWD_TL * (P + 1) + P * (N + 1)
                + 2 * BWD_TL * RB)


def bwd_heads_a_block(C: int, L: int, H: int, G: int, P: int, N: int,
                      bf16: bool) -> int:
    """RB, the heads a tile block walks: each group's R = H / G heads split
    into the fewest even runs that give the grid of (ceil(L / 64) tiles,
    C, G runs) at least :data:`BWD_BLOCKS` blocks, and whose weights fit
    the block's shared memory."""
    R = H // G
    tiles = -(-L // BWD_TL)
    runs = min(R, max(1, -(-BWD_BLOCKS // max(1, C * tiles * G))))
    room = (SMEM_PER_BLOCK - bwd_smem(P, N, 0, bf16)) // (8 * BWD_TL)
    runs = max(runs, -(-R // room))
    return -(-R // runs)


def bwd_launch_plan(x: torch.Tensor, Bm: torch.Tensor) -> dict:
    """How :func:`ssd_chunk_state_bwd_cuda` launches K8's VJP on these
    tensors, on any device (pure Python: the CPU tests rehearse it): the
    tile kernel over (ceil(L / 64) position tiles, C chunks, G x ``runs``
    runs of ``heads_a_block`` heads), then the scan kernel over C x ceil(H
    / 4) head blocks and C x G x ceil(L N / 512) dBm blocks (a thread per
    4 elements).  At (P, N) in
    :data:`BWD_TC_WIDTHS` the tile kernel runs on the tensor cores
    (``route`` "wgmma", one warpgroup a block) and reads x and Bm in
    16-byte units: a 16-byte-aligned base and byte strides in multiples of
    16, else ``ValueError`` naming the tensor; at (32, 16) on the CUDA
    cores.  A (P, N) outside :data:`BWD_WIDTHS` raises ``ValueError``.
    ``scratch_bytes`` is the float32 scratch the wrapper allocates: dw * w
    and dw * e, (C, L, H) each, and the runs' parts of dBm, (C, G, runs,
    L, N)."""
    C, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if (P, N) not in BWD_WIDTHS:
        raise ValueError(f"K8's backward takes (P, N) in {BWD_WIDTHS}, "
                         f"got ({P}, {N})")
    if G == 0 or H % G:
        raise ValueError(f"{H} heads do not split over {G} groups")
    bf16 = x.dtype == torch.bfloat16
    tc = (P, N) in BWD_TC_WIDTHS
    if tc:
        _check_tma(x, "x", ("chunk", "position", "head"))
        _check_tma(Bm, "Bm", ("chunk", "position", "group"))
    R = H // G
    rb = bwd_heads_a_block(C, L, H, G, P, N, bf16) if R else 1
    runs = -(-R // rb) if R else 0
    tiles = -(-L // BWD_TL)
    fp32 = "" if bf16 else "_fp32"
    return {"route": "wgmma" if tc else "cuda_core",
            "kernels": ("ssd_bwd_wgmma_kernel" if tc
                        else "ssd_bwd_cuda_core_kernel",
                        "ssd_bwd_scan_kernel"),
            "counters": (f"ssd_chunk_state_bwd{fp32}",
                         f"ssd_chunk_state_bwd_scan{fp32}"),
            "tile": BWD_TL, "heads_a_block": rb, "runs": runs,
            "grid": (tiles, C, G * runs),
            "threads": BWD_TC_THREADS if tc else BWD_CC_THREADS,
            "grid_scan": (C * -(-H // 4)
                          + C * G * -(-L * N // (4 * BWD_SCAN_THREADS))),
            "threads_scan": BWD_SCAN_THREADS,
            "smem_bytes": bwd_smem(P, N, rb, bf16),
            "scratch_bytes": 4 * (2 * C * L * H + C * G * runs * L * N)}


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


#: the C entry points of the two backward kernels, in launch order
BWD_ENTRIES = ("ssd_chunk_state_bwd_tile", "ssd_chunk_state_bwd_scan")


def ssd_chunk_state_bwd_cuda(x, dt, A, Bm, gstate):
    """K8's VJP on the card (``csrc/ssd_chunk_bwd.cu``): the tile kernel,
    then the scan kernel, on the current stream.  The inputs as
    :func:`ssd_chunk_state_cuda` takes them (at the tensor-core widths
    with :func:`bwd_launch_plan`'s alignment), ``gstate`` (C, H, P, N)
    float32 contiguous.  Returns :func:`ssd_chunk_state_bwd_plain`'s
    ``(dx, ddt, dA_part, dBm)``, dx and dBm contiguous.  Each launch counts
    under :func:`bwd_launch_plan`'s counter; a refused launch raises.
    Nothing differentiates it: an input that requires grad, with grad
    enabled, raises ``NotImplementedError`` (``_refuse_grad``)."""
    _refuse_grad("ssd_chunk_state_bwd_cuda (K8's VJP, no double backward)",
                 None, x, dt, A, Bm, gstate)
    plan, grads, args = _bwd_prepare(x, dt, A, Bm, gstate)
    if args is not None:
        for fn, counter in zip(BWD_ENTRIES, plan["counters"]):
            _bwd_launch(fn, counter, args)
    return grads


def _bwd_prepare(x, dt, A, Bm, gstate):
    """Check the VJP's inputs and allocate its outputs and scratch:
    ``(plan, (dx, ddt, dA_part, dBm), args)``, ``args`` the C arguments of
    both kernels followed by the scratch they point at (None when there is
    nothing to launch)."""
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
        return plan, (dx, ddt.zero_(), dA_part.zero_(), dBm.zero_()), None
    # the scratch: dw * w and dw * e a position and head, and the runs'
    # parts of dBm
    qw = torch.empty((C, L, H), dtype=torch.float32, device=dev)
    qe = torch.empty_like(qw)
    part = torch.empty((C, G, plan["runs"], L, N), dtype=torch.float32,
                       device=dev)
    strides = (ctypes.c_longlong * 6)(x.stride(0), x.stride(1), x.stride(2),
                                      Bm.stride(0), Bm.stride(1),
                                      Bm.stride(2))
    args = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            gstate.data_ptr(), dx.data_ptr(), dBm.data_ptr(), ddt.data_ptr(),
            dA_part.data_ptr(), qw.data_ptr(), qe.data_ptr(), part.data_ptr(),
            strides, C, L, H, P, G, N, plan["heads_a_block"],
            int(x.dtype == torch.bfloat16), _stream())
    # the scratch lives as long as the arguments that point at it
    return plan, (dx, ddt, dA_part, dBm), args + ((qw, qe, part),)


def _bwd_launch(fn: str, counter: str, args) -> None:
    """One backward kernel on ``_bwd_prepare``'s arguments, counted."""
    lib = build.library("ssd_chunk_bwd")
    build.check(getattr(lib, fn)(*args[:-1]), fn)
    launches[counter] += 1


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
