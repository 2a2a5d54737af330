"""Build and load the hand-written Hopper kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), and loaded with :mod:`ctypes`.  All sources compile in
parallel, one ``nvcc`` each, at the first call of :func:`library`; the
libraries land in ``build/repro_torch_kernels/<hash>/`` at the root of
the checkout, keyed by a hash of every file under ``csrc/`` (the
shared ``hopper.cuh`` too) and the flags, so a second
process with the same sources loads them without compiling.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.  A missing compiler or a failed build raises;
there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Dict, Tuple

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[3] / "build"
              / "repro_torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: every pointer and the stream are void*, sizes are int,
# a scale is float, the return value is cudaGetLastError() after the launch
SIGNATURES = {
    "segment_sum": {
        # K1 and K4 end in their lane plan (segment_sum._plan_args)
        "gss_forward": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _P],
        "seg_forward": [_P, _P, _P, _P, _I, _I, _P],
        "gssq_forward": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                         _I, _I, _I, _I, _P],
        "gather_rows": [_P, _P, _P, _P, _I, _I, _P],
        # K6 ends in its lane plan (segment_sum.edge_dot_plan)
        "edge_dot": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _I, _I, _P],
    },
    "gat_fused": {
        "gat_forward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _I, _I, _I, _P],
        "gat_backward_dst": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    # the strides arrive as a pointer to a host array of int64
    "flash_attention": {
        # q, k, v, o, lse (null when serving), strides
        "flash_attention_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _I, _I, _F, _I, _P],
        "flash_attention_smem": [_I, _I, _I],
    },
    # K7's VJP, bf16 and float32 (TF32): q, k, v, o, dO, lse, D, dq, dk,
    # dv, strides, then B, H, K, Sq, Skv, hd, hd_v, causal, window, scale,
    # stream; the shared memory of a block at (hd, hd_v, dkdv)
    "flash_attention_bwd": {
        "flash_attention_bwd_dq": [_P] * 11 + [_I] * 9 + [_F, _P],
        "flash_attention_bwd_dkdv": [_P] * 11 + [_I] * 9 + [_F, _P],
        "flash_attention_bwd_smem": [_I, _I, _I],
    },
    "flash_attention_bwd_tf32": {
        "flash_attention_bwd_tf32_dq": [_P] * 11 + [_I] * 9 + [_F, _P],
        "flash_attention_bwd_tf32_dkdv": [_P] * 11 + [_I] * 9 + [_F, _P],
        "flash_attention_bwd_tf32_smem": [_I, _I, _I],
    },
    "ssd_chunk": {
        "ssd_chunk_state_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _I, _P],
        "ssd_chunk_state_smem": [_I, _I],
    },
    # K8's VJP: x, dt, A, Bm, d state, dx, dBm, ddt, dA partials, the
    # scratch dw * w, dw * e and dBm's parts, strides, then C, L, H, P, G,
    # N, RB (heads a tile block), is_bf16, stream
    "ssd_chunk_bwd": {
        "ssd_chunk_state_bwd_tile": [_P] * 13 + [_I] * 8 + [_P],
        "ssd_chunk_state_bwd_scan": [_P] * 13 + [_I] * 8 + [_P],
        # P, N, RB, is_bf16
        "ssd_chunk_state_bwd_smem": [_I, _I, _I, _I],
    },
}

_libs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the Hopper kernels are built "
                           "with the CUDA toolkit at first use")
    return path


def _build_dir() -> pathlib.Path:
    """``BUILD_ROOT/<hash>``: the hash covers the flags and every file
    under ``csrc/`` by name and content, shared headers included, so a
    change to any of them builds anew."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(p for p in CSRC.rglob("*") if p.is_file()):
        h.update(b"\0" + path.relative_to(CSRC).as_posix().encode() + b"\0")
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Tuple[pathlib.Path, float, Dict[str, str], Dict[str, float]]:
    """Compile every source that is not built yet, all in parallel.
    Returns the build directory, the seconds the build took (0.0 when
    every library was there), nvcc's output per source (with ptxas's
    register and spill report) and the seconds each source's nvcc ran
    (from the common start to its exit)."""
    out_dir = _build_dir()
    todo = [n for n in sorted(SIGNATURES)
            if not (out_dir / f"lib{n}.so").exists()]
    if not todo:
        return out_dir, 0.0, {}, {}
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    logs, nvcc_seconds = {}, {}

    def drain(name, proc):
        # one thread a source reads its output to the end (a full pipe
        # would stall nvcc) and notes when it exits
        logs[name], _ = proc.communicate()
        nvcc_seconds[name] = time.perf_counter() - t0

    readers = [threading.Thread(target=drain, args=(name, proc))
               for name, (_, proc) in procs.items()]
    for th in readers:
        th.start()
    for th in readers:
        th.join()
    for name, (tmp, proc) in procs.items():
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{logs[name]}")
            continue
        os.replace(tmp, out_dir / f"lib{name}.so")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out_dir, time.perf_counter() - t0, logs, nvcc_seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` with its C signatures
    set, building every source first if needed."""
    lib = _libs.get(name)
    if lib is None:
        out_dir = build()[0]
        for n, sigs in SIGNATURES.items():
            loaded = ctypes.CDLL(str(out_dir / f"lib{n}.so"))
            for fn, argtypes in sigs.items():
                getattr(loaded, fn).argtypes = argtypes
                getattr(loaded, fn).restype = ctypes.c_int
            _libs[n] = loaded
        lib = _libs[name]
    return lib


def check(status: int, what: str) -> None:
    """Raise if a launch returned a nonzero ``cudaGetLastError()``."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error "
                           f"{status}")
