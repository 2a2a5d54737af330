"""Tile sizes of K7's float32 VJP (``csrc/flash_attention_bwd_tf32.cu``),
timed side by side on one card.

Each variant is the source with one of ``TileT``'s choices replaced (the
keys a dq block walks at a time, ``BK``; the queries a dk/dv block walks,
``BQ``), built by ``nvcc`` with the port's flags into its own library
under ``build/k7_tf32_vjp_tiles/``.  Every variant runs the same inputs at
each timed width pair of ``chip_smoke.py``'s phase 20(a), is held to the
plain VJP (1e-4 of each gradient's largest element) and timed: the
median of 7 CUDA-event windows of 5 launches, dq and dk/dv apart.

    python3 scripts/k7_tf32_vjp_tiles.py        # on a machine with the card
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

SRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                   "flash_attention_bwd_tf32.cu")
OUT = os.path.join(ROOT, "build", "k7_tf32_vjp_tiles")
BK = "static constexpr int BK = W <= 256 ? 64 : (W <= 384 ? 32 : 16);"
BQ = "static constexpr int BQ = W <= 384 ? 32 : 16;"
#: name: {a line of the source: the line that replaces it}
VARIANTS = {
    "as built": {},
    "dq walks 32 keys to width 128": {
        BK: BK.replace("W <= 256 ? 64 : (W <= 384 ? 32 : 16)",
                       "W <= 384 ? 32 : 16")},
    "dq walks 16 keys at (192, *)": {
        BK: BK.replace("(W <= 384 ? 32 : 16)", "16")},
    "dk/dv walks 16 queries from width 128": {BQ: BQ.replace("384", "192")},
}
#: (B, H, K, Sq, Skv, hd, hd_v), causal: phase 20(a)'s timed cases
SHAPES = {"Qwen2.5-14B": (4, 40, 8, 1024, 1024, 128, 128),
          "Granite hd 64": (2, 16, 8, 1024, 1024, 64, 64),
          "Phi-3 hd 96": (2, 32, 32, 1024, 1024, 96, 96),
          "Gemma hd 256": (2, 16, 16, 1024, 1024, 256, 256),
          "train_lm_100m (192, 192)": (4, 4, 2, 192, 192, 192, 192),
          "MLA (192, 128)": (1, 16, 16, 1024, 1024, 192, 128)}


def build_variant(name, repl, nvcc, flags):
    src = open(SRC).read()
    for old, new in repl.items():
        if old not in src:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        src = src.replace(old, new)
    os.makedirs(OUT, exist_ok=True)
    stem = re.sub(r"\W+", "_", name)
    path = os.path.join(OUT, f"{stem}.cu")
    with open(path, "w", encoding="utf-8") as f:
        f.write(src)
    so = os.path.join(OUT, f"lib{stem}.so")
    cmd = [nvcc, *flags, "-I", os.path.dirname(SRC), "-o", so, path]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def median_window_ms(torch, fn, args) -> float:
    for _ in range(3):
        fn(*args)
    times = []
    for _ in range(7):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        for _ in range(5):
            fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 5)
    return sorted(times)[3]


def main() -> int:
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        print("k7_tf32_vjp_tiles: CUDA is not available", file=sys.stderr)
        return 2
    procs = {n: build_variant(n, r, build._nvcc(), build.NVCC_FLAGS)
             for n, r in VARIANTS.items()}
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        spills = [ln.strip() for ln in log.splitlines()
                  if re.search(r"[1-9]\d* bytes spill", ln)]
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        print(f"{name}: built, {len(spills)} ptxas spill lines", flush=True)
        lib = ctypes.CDLL(so)
        for fn, argtypes in build.SIGNATURES["flash_attention_bwd_tf32"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    bad = []
    for label, (B, H, K, Sq, Skv, hd, hd_v) in SHAPES.items():
        def randn(*shape):
            return torch.randn(*shape, device="cuda", generator=gen)
        q = randn(B, Sq, H, hd).transpose(1, 2)
        k = randn(B, Skv, K, hd).transpose(1, 2)
        v = randn(B, Skv, K, hd_v).transpose(1, 2)
        do = randn(B, Sq, H, hd_v).transpose(1, 2)
        out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True)
        ref = fa.flash_attention_bwd_plain(q, k, v, out, do, lse)
        cells = []
        for name, lib in libs.items():
            # the tuple's last item, D, stays alive with it
            _, grads, held = fa._bwd_prepare(q, k, v, out, do, lse, True, 0,
                                             None)
            args = held[:-1]
            entries = (lib.flash_attention_bwd_tf32_dq,
                       lib.flash_attention_bwd_tf32_dkdv)
            for fn in entries:
                build.check(fn(*args), name)
            torch.cuda.synchronize()
            err = max(((g - r).abs().max() / r.abs().max()).item()
                      for g, r in zip(grads, ref))
            if err > 1e-4:
                bad.append(f"{label} {name}: {err:.2e}")
            ms = [median_window_ms(torch, fn, args) for fn in entries]
            cells.append(f"{name}: dq {ms[0]:.4f} + dk/dv {ms[1]:.4f} = "
                         f"{ms[0] + ms[1]:.4f} ms (err {err:.1e})")
        print(f"{label} | " + " | ".join(cells), flush=True)
    print(f"card: {torch.cuda.get_device_name(0)}")
    if bad:
        print("over the float32 bound: " + "; ".join(bad))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
