"""Batched serving example: greedy decode on the Mamba2 (O(1) state) and a
GQA dense model, reporting prefill/decode tokens/s (the reference's
``examples/serve_batched.py`` on the port's serving launcher).

  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.launch import serve as S

ARCHS = ("mamba2-780m", "phi3-mini-3.8b")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises when CUDA is "
                         "missing)")
    args = ap.parse_args(argv)
    for arch in ARCHS:
        print("=" * 60)
        S.main(["--arch", arch, "--reduced", "--batch", "4",
                "--prompt-len", "32", "--gen", "16", "--device",
                args.device])
    print("serve_batched OK")


if __name__ == "__main__":
    main()
