"""End-to-end training example (the reference's
``examples/train_lm_100m.py`` on the port's trainer): a ~105M-parameter
decoder LM, reduced qwen2.5 at full architecture (12 layers x d_model 768
over 4 heads of 192, so K7 and its VJP at the (192, 192) width pair,
d_ff 2304, GQA + QKV bias + SwiGLU + RoPE, vocab 8192), trained for a few
hundred steps on the synthetic bigram corpus; it prints the corpus's
unigram entropy, the floor a model beats only by learning the planted
bigram table.  Checkpoints go to ``repro_torch_lm_ckpt`` under the
temporary directory.

  PYTHONPATH=src python -m repro_torch.examples.train_lm_100m \\
      [--steps 220] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

from repro_torch.data.pipeline import unigram_entropy
from repro_torch.launch import train as T

VOCAB = 8192


def main(argv=None) -> dict:
    """Train; returns the trainer's result (params, losses, ...) with the
    unigram-entropy floor under ``"unigram_entropy"``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=220)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises when CUDA is "
                         "missing)")
    args = ap.parse_args(argv)
    ckpt = os.path.join(tempfile.gettempdir(), "repro_torch_lm_ckpt")
    out = T.run(T.parse_args([
        "--arch", "qwen2.5-14b", "--reduced",
        "--layers", "12", "--d-model", "768", "--d-ff", "2304",
        "--vocab", str(VOCAB),
        "--steps", str(args.steps), "--batch", "4", "--seq", "192",
        "--lr", "1e-3", "--ckpt-dir", ckpt, "--device", args.device]))
    out["unigram_entropy"] = unigram_entropy(VOCAB)
    print(f"unigram entropy floor: {out['unigram_entropy']:.3f} nats")
    return out


if __name__ == "__main__":
    sys.exit(0 if main() is not None else 1)
