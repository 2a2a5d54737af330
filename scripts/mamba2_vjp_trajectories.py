#!/usr/bin/env python3
"""How far Mamba2-780m's short training run moves when K8's VJP changes
at roundoff level, on the card.

Runs ``chip_smoke.py``'s phase 20(c) trainer argv (full depth, bf16, B 2
x S 1024, 4 AdamW steps at lr 3e-4) four times from the same seed and
prints each run's losses and grad norms:

- ``kernel``: through K8's VJP kernels, as the trainer runs;
- ``kernel_again``: the same (bitwise the first: the kernels hold no
  atomics);
- ``perturbed``: the kernels' ddt and dA partials times (1 + 2^-20), a
  change at float32 roundoff;
- ``plain_vjp``: ``ssd_chunk_state_bwd_plain`` (the float32 formulas in
  PyTorch) in the kernels' place.

The spread of the last three against the first is the trajectory's
sensitivity to roundoff (AdamW's first steps normalize every gradient
element, and the bf16 model rounds after each op), the yardstick for a
loss that differs from an earlier kernel's.

    python3 scripts/mamba2_vjp_trajectories.py
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mamba2_vjp_trajectories: CUDA is not available",
              file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.launch import train as T

    kernel = sc.ssd_chunk_state_bwd_cuda

    def perturbed(*args):
        dx, ddt, dA_part, dBm = kernel(*args)
        return dx, ddt * (1 + 2.0 ** -20), dA_part * (1 + 2.0 ** -20), dBm

    argv = dict((k, a) for k, _, a, _ in cs.TRAIN_RUNS)[cs.MAMBA2]
    runs = {}
    try:
        for name, fn in (("kernel", kernel), ("kernel_again", kernel),
                         ("perturbed", perturbed),
                         ("plain_vjp", sc.ssd_chunk_state_bwd_plain)):
            sc.ssd_chunk_state_bwd_cuda = fn
            out = T.run(T.parse_args(argv))
            runs[name] = {"losses": out["losses"],
                          "grad_norms": out["grad_norms"]}
            print(name, json.dumps(runs[name]), flush=True)
            del out
            torch.cuda.empty_cache()
    finally:
        sc.ssd_chunk_state_bwd_cuda = kernel
    print(json.dumps({"card": cs.nvidia_smi_line(), "argv": argv,
                      "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
