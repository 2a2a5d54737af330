"""GNN models: stacks of abstraction-layer GNN layers, usable in
full-graph mode (one DeviceGraph) or mini-batch mode (list of blocks),
with the reference's loss and training steps.

The model is an ``nn.ModuleList`` whose entry ``i`` is the layer module
holding the reference's ``params[i]`` dict, so the functions keep the
reference's signatures (``cfg, params, ...``) and indexing.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.abstraction import DeviceGraph
from repro_torch.core.comm import QuantizedRows
from repro_torch.models.gnn.layers import APPNPLayer, LAYER_TYPES


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    arch: str = "gcn"                 # gcn | sage | gat | gin | ggnn | appnp
    feat_dim: int = 64
    hidden: int = 128
    num_classes: int = 8
    num_layers: int = 2
    gat_heads: int = 4
    appnp_k: int = 4                  # APPNP propagation hops
    appnp_alpha: float = 0.1
    # kept for parity with the reference config; in the port the device
    # decides: CUDA tensors always run the Hopper kernels, CPU tensors
    # their plain versions
    use_kernel: bool = False
    wire_codec: str = "fp32"          # comm-plane codec: fp32 | bf16 | int8


def init_gnn(cfg: GNNConfig, gen: torch.Generator, *,
             device: Union[str, torch.device] = "cuda") -> nn.ModuleList:
    """Randomly initialized model on ``device``, drawn from ``gen`` (a CPU
    ``torch.Generator``; its numbers differ from JAX's)."""
    device = torch.device(device)
    if cfg.arch == "appnp":
        # MLP head (feat -> hidden -> classes), then weightless propagation
        return nn.ModuleList([
            APPNPLayer(cfg.feat_dim, cfg.hidden, alpha=cfg.appnp_alpha,
                       device=device, gen=gen),
            APPNPLayer(cfg.hidden, cfg.num_classes, alpha=cfg.appnp_alpha,
                       device=device, gen=gen)])
    layer_cls = LAYER_TYPES[cfg.arch]
    dims = ([cfg.feat_dim] + [cfg.hidden] * (cfg.num_layers - 1)
            + [cfg.num_classes])
    kw = {"heads": cfg.gat_heads} if cfg.arch == "gat" else {}
    return nn.ModuleList([layer_cls(dims[i], dims[i + 1], device=device,
                                    gen=gen, **kw)
                          for i in range(cfg.num_layers)])


def params_from_numpy(cfg: GNNConfig, params_np: Sequence[dict], *,
                      device: Union[str, torch.device] = "cuda"
                      ) -> nn.ModuleList:
    """The port's model on ``device`` holding the reference's weights:
    ``params_np`` is ``init_gnn(cfg, key)`` of the JAX package mapped to
    numpy (a list of dicts; GGNN's ``proj`` may be None)."""
    model = init_gnn(cfg, torch.Generator().manual_seed(0), device=device)
    if len(params_np) != len(model):
        raise ValueError(f"{len(params_np)} param dicts for "
                         f"{len(model)} layers")
    with torch.no_grad():
        for layer, p in zip(model, params_np):
            own = {k for k, _ in layer.named_parameters()}
            given = {k for k, v in p.items() if v is not None}
            if own != given:
                raise ValueError(f"param keys {sorted(given)} do not match "
                                 f"the layer's {sorted(own)}")
            for k in given:
                dst = getattr(layer, k)
                src = torch.from_numpy(np.array(p[k], np.float32))
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{k}: shape {tuple(src.shape)} != "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src)
    return model


def forward_full(cfg: GNNConfig, params: nn.ModuleList, g: DeviceGraph,
                 x: torch.Tensor) -> torch.Tensor:
    """Full-graph forward (NeuGraph/ROC style, no sampling)."""
    if cfg.arch == "appnp":
        l0, l1 = params
        h = F.relu(x @ l0.w) @ l1.w
        h0 = h
        for _ in range(cfg.appnp_k):
            h = l0.propagate(g, h, h0)
        return h
    h = x
    for i, layer in enumerate(params):
        h = layer(g, h)
        if i + 1 < len(params):
            h = F.relu(h)
    return h


def forward_blocks(cfg: GNNConfig, params: nn.ModuleList,
                   blocks: Sequence[DeviceGraph], x_input) -> torch.Tensor:
    """Mini-batch forward over sampled bipartite blocks (DistDGL style).
    ``x_input``: features of blocks[0].src_nodes."""
    _check_sampled(cfg)
    h = x_input
    for i, (layer, g) in enumerate(zip(params, blocks)):
        h = layer(g, _pad_rows(h, g.num_src))
        if i + 1 < len(params):
            h = F.relu(h)
    return h


def _pad_rows(h, num_src: int):
    """``h`` with zero rows appended up to ``num_src``.  The training
    sampler makes a block's destinations only the previous block's valid
    sources, so a layer's output can be shorter than the next block's
    padded source list; the rows added are never read by a listed edge,
    and the layouts (built over ``num_src``) then match the rows."""
    if isinstance(h, QuantizedRows) or h.shape[0] >= num_src:
        return h
    return F.pad(h, (0, 0, 0, num_src - h.shape[0]))


def forward_blocks_cached(cfg: GNNConfig, params: nn.ModuleList,
                          inner_blocks: Sequence[DeviceGraph],
                          outer_block: DeviceGraph, x_input,
                          cached_h: torch.Tensor, fresh_mask: torch.Tensor):
    """Serving forward with historical-embedding splice (GNNAutoScale).

    Computes the first ``L-1`` layers over the (possibly miss-restricted)
    inner blocks, then replaces rows of the final-layer input with cached
    historical embeddings where ``fresh_mask`` holds, and applies the last
    layer over ``outer_block``.  Returns ``(logits, h_fresh)`` where
    ``h_fresh`` is the pre-splice hidden state — the rows to write back for
    cache misses."""
    _check_sampled(cfg)
    h = x_input
    for i in range(len(params) - 1):
        h = F.relu(params[i](inner_blocks[i], h))
    h_fresh = h
    h = torch.where(fresh_mask[:, None], cached_h, h_fresh)
    logits = params[-1](outer_block, h)
    return logits, h_fresh


def _check_sampled(cfg: GNNConfig) -> None:
    # APPNP is a full-graph model (the reference fails here too, with a
    # KeyError: its LAYER_TYPES has no "appnp")
    if cfg.arch == "appnp":
        raise ValueError("appnp runs full-graph; use forward_full")


def nll_sum_count(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor):
    """Masked NLL as an (unnormalized sum, count) pair — the combinable
    form a distributed step all-reduces before dividing."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.sum((logz - gold) * mask), torch.sum(mask)


def nll_loss(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor = None) -> torch.Tensor:
    if mask is None:
        mask = torch.ones(labels.shape, dtype=logits.dtype,
                          device=logits.device)
    total, cnt = nll_sum_count(logits, labels, mask)
    return total / torch.clamp(cnt, min=1.0)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor = None) -> torch.Tensor:
    correct = (torch.argmax(logits, -1) == labels).to(torch.float32)
    if mask is not None:
        return torch.sum(correct * mask) / torch.clamp(torch.sum(mask),
                                                       min=1.0)
    return torch.mean(correct)


def make_fullgraph_train_step(cfg: GNNConfig, optimizer):
    """``step(params, g, x, labels, mask) -> loss``: forward, NLL,
    ``backward()`` and one ``optimizer`` step on ``params`` (the model the
    optimizer was built on).  ``g`` needs its src-grouped layout
    (``DeviceGraph.from_graph(..., src_layout=True)``).  The loss comes
    back as a detached 0-d tensor on the device (reading it waits)."""
    def step(params: nn.ModuleList, g: DeviceGraph, x, labels, mask):
        optimizer.zero_grad(set_to_none=True)
        loss = nll_loss(forward_full(cfg, params, g, x), labels, mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_minibatch_train_step(cfg: GNNConfig, optimizer):
    """``step(params, blocks, x_input, labels, mask) -> loss`` over
    sampled blocks built with their src-grouped layouts; ``x_input`` may
    be ``QuantizedRows`` (SAGE's layer 0 aggregates them as they are)."""
    def step(params: nn.ModuleList, blocks: Sequence[DeviceGraph], x_input,
             labels, mask):
        optimizer.zero_grad(set_to_none=True)
        loss = nll_loss(forward_blocks(cfg, params, blocks, x_input),
                        labels, mask)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
