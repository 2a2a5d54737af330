"""K8: the Mamba2 SSD per-chunk state, forward only.

``state[c, h, p, n] = sum_l exp(cumA_L - cumA_l) * dt_l * x[c,l,h,p] *
Bm[c,l,h // (H/G),n]`` with ``cumA`` the running sum of ``dt * A[h]`` over
the chunk's positions.

:func:`ssd_chunk_state_cuda` launches the hand-written Hopper kernel
(``csrc/ssd_chunk.cu``), the counterpart of the reference's Pallas kernel
``src/repro/kernels/ssd_chunk.py:42`` (``ssd_chunk_state_pallas``;
``pallas_call`` at ``:55``).  :func:`ssd_chunk_state_plain` is the
reference's oracle (``src/repro/kernels/ref.py:40``) in PyTorch.  Both
take x (C, L, H, P), dt (C, L, H), A (H,), Bm (C, L, G, N) and return
(C, H, P, N) float32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.segment_sum import (_check_view, _require_cuda,
                                             _stream)

#: launches of the kernel wrapper (a run resets and reads it)
launches = {"ssd_chunk_state": 0}


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
    last dim contiguous; dt contiguous float32; A float32; P % 4 == 0 and
    N % 8 == 0."""
    dev = _require_cuda(x, "ssd_chunk_state_cuda")
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
    if P % 4 or N % 8:
        raise ValueError(f"P {P} must be a multiple of 4 and N {N} of 8")
    out = torch.empty((C, H, P, N), dtype=torch.float32, device=dev)
    if out.numel() == 0 or L == 0:
        return out.zero_()
    strides = (ctypes.c_longlong * 6)(x.stride(0), x.stride(1), x.stride(2),
                                      Bm.stride(0), Bm.stride(1),
                                      Bm.stride(2))
    lib = build.library("ssd_chunk")
    build.check(lib.ssd_chunk_state_fwd(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        out.data_ptr(), strides, C, L, H, P, G, N,
        int(x.dtype == torch.bfloat16), _stream()), "ssd_chunk_state_fwd")
    launches["ssd_chunk_state"] += 1
    return out
