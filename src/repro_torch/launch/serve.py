"""Serving launcher of the transformer zoo (PyTorch port of the reference's
``launch/serve.py``): batched greedy decoding against a KV / state cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --reduced --batch 8 --prompt-len 64 --gen 32 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-1b-a400m --reduced --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-v3-671b --reduced --device cpu

As in the reference, the loop is decode-only: the prompt is fed through
``decode_step`` one position at a time into a cache sized for prompt and
generation, then ``--gen`` tokens are generated greedily (argmax over
the real vocabulary, not the padded columns).  ``--device`` defaults to
``cuda``.  Prompts and weights come from torch generators seeded by
``--seed``.  The ``vlm`` and ``encdec`` families are refused as the
reference refuses them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.configs.base import ARCH_FAMILIES, arch_module, get_config
from repro_torch.models.transformer import model as M


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; raises "
                         "when CUDA is missing)")
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(argv=None) -> dict:
    """Serve as :func:`main` does, printing nothing; returns the generated
    tokens (B, gen), the last decode logits, both rates in tokens per
    second, the config and the parsed flags."""
    args = parse_args(argv)
    if ARCH_FAMILIES[arch_module(args.arch)] in ("vlm", "encdec"):
        raise SystemExit("use examples/whisper_vlm_smoke.py for stub-"
                         "frontend families")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = D.resolve(args.device)
    B, S, GEN = args.batch, args.prompt_len, args.gen
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device=dev)

    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=dev)

    # decode-only serving loop against a pre-sized cache (the prompt is
    # folded into the loop so every position exercises decode_step)
    cache = M.init_cache(cfg, B, S + GEN, device=dev)
    with torch.inference_mode():
        t0 = time.time()
        logits = None
        for t in range(S):
            logits, cache = M.decode_step(cfg, params, cache,
                                          {"token": prompts[:, t:t + 1],
                                           "pos": t})
        _sync(dev)
        t_prefill = time.time() - t0

        t0 = time.time()
        out = []
        tok = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]
        for i in range(GEN):
            out.append(tok)
            logits, cache = M.decode_step(cfg, params, cache,
                                          {"token": tok, "pos": S + i})
            tok = torch.argmax(logits[:, :cfg.vocab_size], -1)[:, None]
        _sync(dev)
        t_gen = time.time() - t0

    gen_tokens = torch.cat(out, dim=1).cpu().numpy() if out else \
        np.zeros((B, 0), np.int64)
    return {"tokens": gen_tokens, "logits": logits, "cfg": cfg,
            "args": args, "params": M.param_count(params), "device": dev,
            "prefill_tok_s": B * S / t_prefill,
            "decode_tok_s": B * GEN / t_gen if GEN else 0.0}


def main(argv=None):
    res = run(argv)
    args = res["args"]
    print(f"arch={res['cfg'].name} params={res['params']:,} "
          f"batch={args.batch} prompt={args.prompt_len} gen={args.gen} "
          f"device={res['device']}")
    print(f"prefill: {res['prefill_tok_s']:,.0f} tok/s  "
          f"decode: {res['decode_tok_s']:,.0f} tok/s")
    print("first sequences:", res["tokens"][0, :8].tolist())
    return res["tokens"]


if __name__ == "__main__":
    main()
