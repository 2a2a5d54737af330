"""How far ``model.prefill``'s logits at a prompt's last position lie
from those of the serving launcher's decode-only loop (``launch/serve.py``
feeds the prompt through ``decode_step`` one position at a time).

  PYTHONPATH=src python -m repro_torch.launch.prefill_gap \\
      --arch mamba2-780m --dtype float32 --batch 2 --prompt-len 1024 \\
      --device cpu

``--layers N`` cuts the config to its first N layers at its published
widths (Zamba2-2.7B: a multiple of its ``attn_every``, 6; DeepSeek-V3:
``min(first_dense_layers, N - 1)`` dense layers, so that every cut
holds at least one MoE layer, as ``reduced()`` does).
``--capacity-factor`` sets a ``moe`` or ``mla_moe`` config's GShard
capacity factor for both paths: a prefill groups its prompt's tokens and
a decode step the batch, so at the published 1.25 the two drop
different tokens, and only a drop-free factor (at least E/k, Granite's
4, DeepSeek-V3's 32) compares the paths.

The two paths compute one function by two algorithms (chunked SSD or
flash attention over the whole prompt; the recurrent update or the
softmax over the cache, one position at a time), so on the same prompt
their gap is roundoff.  ``--flip POS`` is the control: the decode loop
reads the prompt with the token at ``POS`` changed, which gives the gap
that a one-token difference makes.  Weights and prompts come from torch
generators seeded by ``--seed``; ``--device`` defaults to ``cuda``.
Prints one JSON object.

The stub-frontend families take their inputs from the same generator.
``vlm`` (Qwen2-VL) reads embeddings (B, S, d_model) drawn from N(0, 1)
at text-style positions (0..S-1 in all three M-RoPE streams), the only
layout one-token decode reproduces: decode rotates at the cache slot
(as the reference's does); ``--flip`` redraws that position's
embedding.  ``encdec`` (Whisper) reads encoder frames (B, ``--enc-len``,
d_model) from N(0, 1) and decoder tokens; its decode-only loop takes the
cross cache, which only ``prefill`` builds, from a prefill over the
first token, then decodes positions 1..S-1.

  PYTHONPATH=src python -m repro_torch.launch.prefill_gap \\
      --arch whisper-tiny --reduced --enc-len 64 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.prefill_gap \\
      --arch qwen2-vl-7b --reduced --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import device as D
from repro_torch.configs.base import get_config
from repro_torch.models.transformer import model as M


def decode_loop(cfg, params, batch) -> torch.Tensor:
    """The serving launcher's decode-only loop over a prompt: the logits
    (B, padded_vocab) at its last position.  ``batch`` is ``prefill``'s
    (a (B, S) token tensor stands for ``{"tokens": it}``).  ``vlm`` feeds
    its embeddings one position at a time (its M-RoPE positions are not
    read: decode rotates at the slot, so compare text-style positions
    only); ``encdec`` takes its cross cache and the first self slot from
    a prefill over the first token, then decodes positions 1..S-1 in a
    self cache of S slots."""
    if isinstance(batch, torch.Tensor):
        batch = {"tokens": batch}
    key, step_key = (("embeds", "embeds") if cfg.family == "vlm"
                     else ("tokens", "token"))
    feed = batch[key]
    B, S = feed.shape[:2]
    cache = M.init_cache(cfg, B, S, device=feed.device)
    logits, start = None, 0
    if cfg.family == "encdec":
        logits, first = M.prefill(cfg, params, {
            "enc_embeds": batch["enc_embeds"], "tokens": feed[:, :1]})
        cache["cross"] = first["cross"]
        for name in ("k", "v"):
            cache["self"][name][:, :, :1] = first["self"][name]
        start = 1
    for t in range(start, S):
        logits, cache = M.decode_step(cfg, params, cache,
                                      {step_key: feed[:, t:t + 1], "pos": t})
    return logits


def stub_inputs(cfg, B: int, S: int, gen: torch.Generator, dev, *,
                enc_len: int = 0) -> dict:
    """``prefill``'s batch of S positions drawn from ``gen``: tokens;
    ``vlm``'s embeddings from N(0, 1) at text-style positions (all three
    M-RoPE streams 0..S-1); ``encdec``'s encoder frames (B, enc_len,
    d_model) from N(0, 1) beside the tokens."""
    if cfg.family == "vlm":
        embeds = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
        positions = torch.arange(S, device=dev).expand(3, B, S)
        return {"embeds": embeds, "positions": positions}
    batch = {}
    if cfg.family == "encdec":
        batch["enc_embeds"] = torch.randn((B, enc_len, cfg.d_model),
                                          generator=gen, device=dev)
    batch["tokens"] = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                    device=dev)
    return batch


def gap(a: torch.Tensor, b: torch.Tensor) -> dict:
    """How far logits ``a`` are from ``b``: the largest absolute gap, the
    largest |b|, their ratio, the RMS ratio |a - b| / |b| and the share
    of rows whose argmax agrees."""
    a, b = a.float(), b.float()
    max_abs, ref = (a - b).abs().max().item(), b.abs().max().item()
    return {"max_abs": max_abs, "max_abs_ref": ref,
            "max_abs_rel": max_abs / ref if ref else float("inf"),
            "rms_ratio": ((a - b).norm() / b.norm()).item(),
            "argmax_agree": (a.argmax(-1) == b.argmax(-1)).float().mean()
            .item()}


def cut_layers(cfg, n: int):
    """``cfg`` cut to its first ``n`` layers; an ``mla_moe`` config keeps
    ``min(first_dense_layers, n - 1)`` dense layers, so that the cut holds
    at least one MoE layer."""
    if cfg.family == "mla_moe":
        return cfg.replace(num_layers=n, first_dense_layers=min(
            cfg.first_dense_layers, n - 1))
    return cfg.replace(num_layers=n)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--dtype", default=None,
                    help="param and compute dtype (default: the config's)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to its first N layers, its widths "
                         "kept (default: all); an mla_moe config keeps "
                         "min(first_dense_layers, N - 1) dense layers, so "
                         "that the cut holds a MoE layer")
    ap.add_argument("--capacity-factor", type=float, default=None,
                    help="a moe or mla_moe config's capacity factor "
                         "(default: the config's)")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--enc-len", type=int, default=1500,
                    help="encdec: encoder frames (default 1500, Whisper's "
                         "30-s window after its stride-2 conv stem)")
    ap.add_argument("--flip", type=int, default=None,
                    help="control: change the decode loop's token (vlm: "
                         "embedding) at this prompt position")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; raises when CUDA is "
                         "missing)")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """The gap of prefill against the decode-only loop, with the run's
    settings and its seconds."""
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = cfg.replace(param_dtype=args.dtype, compute_dtype=args.dtype)
    if args.layers:
        cfg = cut_layers(cfg, args.layers)
    if args.capacity_factor is not None:
        if not cfg.num_experts:
            raise ValueError(f"--capacity-factor: {cfg.name} has no "
                             f"experts")
        cfg = cfg.replace(moe_capacity_factor=args.capacity_factor)
    dev = D.resolve(args.device)
    B, S, V = args.batch, args.prompt_len, cfg.vocab_size
    if args.flip is not None and not 0 <= args.flip < S:
        raise ValueError(f"--flip {args.flip} outside a prompt of {S}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, device=dev)
    enc_len = args.enc_len if cfg.family == "encdec" else 0
    batch = stub_inputs(cfg, B, S, gen, dev, enc_len=enc_len)
    read = dict(batch)
    if args.flip is not None:
        if cfg.family == "vlm":
            read["embeds"] = batch["embeds"].clone()
            read["embeds"][:, args.flip] = torch.randn(
                (B, cfg.d_model), generator=gen, device=dev)
        else:
            read["tokens"] = batch["tokens"].clone()
            read["tokens"][:, args.flip] = (batch["tokens"][:, args.flip]
                                            + 1) % V
    t0 = time.perf_counter()
    with torch.inference_mode():
        lg, _ = M.prefill(cfg, params, batch)
        dl = decode_loop(cfg, params, read)
    res = gap(lg[:, :V], dl[:, :V])
    res.update(arch=cfg.name, dtype=cfg.compute_dtype, layers=cfg.num_layers,
               d_model=cfg.d_model, batch=B, prompt_len=S, flip=args.flip,
               capacity_factor=(cfg.moe_capacity_factor
                                if cfg.num_experts else None),
               enc_len=enc_len or None, device=str(dev),
               seconds=time.perf_counter() - t0)
    return res


def main(argv=None) -> dict:
    res = run(argv)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
