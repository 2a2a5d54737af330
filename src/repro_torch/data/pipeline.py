"""Synthetic LM data for the transformer trainer: the reference's
``src/repro/data/pipeline.py`` (:class:`SyntheticLMDataset`,
:func:`batch_iterator`) in numpy alone, batch for batch the same arrays
from the same seed.

:class:`SyntheticLMDataset` is a deterministic corpus of Zipf-distributed
tokens with planted bigram transitions: a model that learns the bigram
table reaches a loss far below the unigram entropy, so the examples show
real learning without shipping data.

:func:`input_specs` gives shape stand-ins for every model input of a
(config x input shape), tensors on the meta device (nothing allocated),
for the sharding-plan dry run (``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

I32 = torch.int32


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape) -> Dict[str, torch.Tensor]:
    """Abstract model inputs for a (config, shape) pair (the reference's
    ``data/pipeline.py:30``): meta tensors of its shapes and dtypes.

    train/prefill get full sequences; decode gets one token + a position.
    The modality-frontend carve-out: vlm gets patch/text embeddings, encdec
    gets encoder frame embeddings (both precomputed, as in the reference).
    """
    B, S = shape.global_batch, shape.seq_len
    cdt = torch.bfloat16 if cfg.compute_dtype == "bfloat16" \
        else torch.float32
    kind = shape.kind
    fam = cfg.family

    if kind in ("train", "prefill"):
        if fam == "vlm":
            batch = {"embeds": _sds((B, S, cfg.d_model), cdt),
                     "positions": _sds((3, B, S), I32)}
        elif fam == "encdec":
            batch = {"enc_embeds": _sds((B, S, cfg.d_model), cdt),
                     "tokens": _sds((B, S), I32)}
        else:
            batch = {"tokens": _sds((B, S), I32)}
        if kind == "train":
            batch["labels"] = _sds((B, S), I32)
        return batch

    # decode: one new token against a cache of S positions
    if fam == "vlm":
        return {"embeds": _sds((B, 1, cfg.d_model), cdt),
                "pos": _sds((), I32)}
    return {"token": _sds((B, 1), I32), "pos": _sds((), I32)}


def zipf_unigram(vocab_size: int) -> np.ndarray:
    """The corpus's token marginal: p(rank r) proportional to 1 / r,
    float64."""
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    return (1.0 / ranks) / np.sum(1.0 / ranks)


class SyntheticLMDataset:
    """Zipfian unigrams plus planted bigram transitions: each next token
    is ``next_tok[prev]`` with probability ``bigram_det``, else a fresh
    Zipf draw."""

    def __init__(self, vocab_size: int, seq_len: int, *, seed: int = 0,
                 bigram_det: float = 0.8):
        self.vocab = vocab_size
        self.seq = seq_len
        self.rng = np.random.default_rng(seed)
        self.unigram = zipf_unigram(vocab_size)
        self.next_tok = self.rng.permutation(vocab_size)
        self.bigram_det = bigram_det

    def sample(self, batch: int) -> np.ndarray:
        """(batch, seq + 1) int64 token rows."""
        out = np.empty((batch, self.seq + 1), np.int64)
        out[:, 0] = self.rng.choice(self.vocab, size=batch, p=self.unigram)
        for t in range(1, self.seq + 1):
            det = self.next_tok[out[:, t - 1]]
            rnd = self.rng.choice(self.vocab, size=batch, p=self.unigram)
            use = self.rng.random(batch) < self.bigram_det
            out[:, t] = np.where(use, det, rnd)
        return out

    def batches(self, batch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Endless ``{"tokens", "labels"}`` int32 (batch, seq) pairs, the
        labels the tokens shifted by one."""
        while True:
            seqs = self.sample(batch)
            yield {"tokens": seqs[:, :-1].astype(np.int32),
                   "labels": seqs[:, 1:].astype(np.int32)}


def batch_iterator(cfg, batch: int, seq: int, *, seed: int = 0):
    """The batches of a :class:`SyntheticLMDataset` over ``cfg``'s
    vocabulary."""
    ds = SyntheticLMDataset(cfg.vocab_size, seq, seed=seed)
    return ds.batches(batch)


def unigram_entropy(vocab_size: int) -> float:
    """The corpus's unigram entropy in nats: the loss of a model that
    knows only the marginals, the floor a model beats by learning the
    bigram table (``examples/train_lm_100m.py`` prints it)."""
    p = zipf_unigram(vocab_size)
    return float(-np.sum(p * np.log(p)))
