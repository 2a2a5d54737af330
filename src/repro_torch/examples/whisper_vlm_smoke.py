"""The stub-frontend families end to end (the reference's
``examples/whisper_vlm_smoke.py`` on the port): 10 AdamW steps each of
reduced Whisper-tiny (precomputed frame embeddings) and Qwen2-VL
(precomputed patch embeddings and M-RoPE positions), the loss falling,
then one decode step.  Whisper prefills S - 1 tokens and decodes at
position S - 1 in its self cache grown by one slot (the reference writes
that step over its last slot; ROADMAP.md, queue 3).

Inputs come from a numpy generator (seed 0), a fresh batch a step:
normal embeddings, and labels drawn from the synthetic corpus's Zipf
unigram (``data.pipeline.zipf_unigram``), Whisper's tokens equal to its
labels.  The reference draws its tokens and labels uniformly from one
key, so its Whisper labels are its tokens too; with uniform labels
Qwen2-VL has nothing to learn in 10 steps but flatter logits, and
whether the last loss lies below the first rests on the draw (on the
CPU the port's loss stayed within 0.1 of 6.7 over 10 steps for several
seeds), where a Zipf marginal gives it a fall of about 0.5.

  PYTHONPATH=src python -m repro_torch.examples.whisper_vlm_smoke \\
      [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import zipf_unigram
from repro_torch.models.transformer import model as M
from repro_torch.optim import AdamW

B, S = 4, 64
ARCHS = ("whisper-tiny", "qwen2-vl-7b")


def _batch(cfg, rng, dev) -> dict:
    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev)

    labels = torch.from_numpy(rng.choice(
        cfg.vocab_size, size=(B, S), p=zipf_unigram(cfg.vocab_size)
    ).astype(np.int32)).to(dev)
    if cfg.family == "encdec":
        batch = {"enc_embeds": normal(B, S, cfg.d_model), "tokens": labels}
    else:
        pos = np.broadcast_to(np.arange(S)[None, None], (3, B, S))
        batch = {"embeds": normal(B, S, cfg.d_model),
                 "positions": torch.from_numpy(pos.astype(np.int32)).to(dev)}
    batch["labels"] = labels
    return batch


def _grow_self(cache, n: int) -> dict:
    """The encdec cache with ``n`` zero slots more in its self K/V (the
    cross K/V untouched: zero slots there would enter its softmax)."""
    def pad(c):
        return torch.cat([c, c.new_zeros(c.shape[:2] + (n,) + c.shape[3:])],
                         dim=2)
    return {"self": {k: pad(v) for k, v in cache["self"].items()},
            "cross": cache["cross"]}


def run_arch(arch: str, dev, rng) -> dict:
    """Train one family 10 steps, then one decode step; returns its
    losses and the decode logits' shape."""
    cfg = get_config(arch).reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, gen, max_seq=S + 8, device=dev)
    step = M.make_train_step(cfg, AdamW(M.trainable(params), lr=1e-3),
                             remat=False)
    losses = []
    for _ in range(10):
        batch = _batch(cfg, rng, dev)
        losses.append(float(step(params, batch)["loss"]))
    print(f"{arch}: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({M.param_count(params):,} params)")
    assert losses[-1] < losses[0], f"{arch}: the loss did not fall"

    with torch.no_grad():
        if cfg.family == "encdec":
            _, cache = M.prefill(cfg, params,
                                 {"enc_embeds": batch["enc_embeds"],
                                  "tokens": batch["tokens"][:, :S - 1]})
            cache = _grow_self(cache, 1)
            db = {"token": batch["tokens"][:, -1:], "pos": S - 1}
        else:
            cache = M.init_cache(cfg, B, S, enc_len=S, device=dev)
            db = {"embeds": torch.from_numpy(rng.standard_normal(
                (B, 1, cfg.d_model)).astype(np.float32)).to(dev),
                "pos": S // 2}
        logits, _ = M.decode_step(cfg, params, cache, db)
    assert not torch.isnan(logits.float()).any(), f"{arch}: NaN logits"
    print(f"{arch}: decode_step OK, logits {tuple(logits.shape)}")
    return {"losses": losses, "decode_logits_shape": tuple(logits.shape)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises when CUDA is "
                         "missing)")
    args = ap.parse_args(argv)
    dev = D.resolve(args.device)
    rng = np.random.default_rng(0)
    out = {arch: run_arch(arch, dev, rng) for arch in ARCHS}
    print("whisper_vlm_smoke OK")
    return out


if __name__ == "__main__":
    main()
