"""Training driver for the transformer zoo (the reference's
``src/repro/launch/train.py``), on the device ``--device`` names
(``cuda`` by default; without a card that raises).

It trains a config of ``repro_torch.configs`` on the synthetic bigram
corpus (:mod:`repro_torch.data.pipeline`) with the port's AdamW under a
cosine schedule: every step is :func:`repro_torch.models.transformer.
model.make_train_step`, whose backward on the card runs K7's and K8's
hand-written VJPs (``FlashAttention``, ``SSDChunkState``) beside
PyTorch's own for the rest.  ``--reduced`` trains the config's smoke
variant; ``--d-model`` (which also sets ``head_dim = d_model //
num_heads``), ``--d-ff``, ``--layers`` and ``--vocab`` override it, as
in the reference.  ``vlm`` and ``encdec`` need precomputed frontend
embeddings and are refused, as in the reference
(``examples/whisper_vlm_smoke.py`` trains them).  Every batch is drawn
before the first step; each step ends in a synchronise, so its seconds
are the device's.  ``--ckpt-dir`` saves the params and AdamW's state
(``{"params", "opt": {"m", "v", "step"}}``) every ``--ckpt-every``
steps through :mod:`repro_torch.checkpoint`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \\
      --reduced --steps 5 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
      --steps 20 --batch 2 --seq 1024
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import device as D
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.kernels import ops
from repro_torch.models.transformer import model as M
from repro_torch.optim import AdamW, cosine_schedule


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--vocab", type=int, default=0,
                    help="override vocab (synthetic data scales with it)")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def config(args):
    """The config the flags name, with the reference's overrides; raises
    ``SystemExit`` for the families that train on precomputed frontend
    embeddings."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    overrides = {}
    if args.vocab:
        overrides["vocab_size"] = args.vocab
    if args.d_model:
        overrides["d_model"] = args.d_model
        if cfg.num_heads:
            overrides["head_dim"] = args.d_model // cfg.num_heads
    if args.d_ff:
        overrides["d_ff"] = args.d_ff
    if args.layers:
        overrides["num_layers"] = args.layers
    if overrides:
        cfg = cfg.replace(**overrides)
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit(
            f"{cfg.family} training uses precomputed frontend embeddings; "
            "see repro_torch/examples/whisper_vlm_smoke.py")
    return cfg


def opt_state(params, opt) -> dict:
    """AdamW's state as a tree beside the params: ``{"m", "v"}`` in the
    params' layout (float32) and the step count."""
    def moment(name):
        return M._map(lambda p, _: opt.state[p][name], params, params)
    leaves = list(M._leaves(params))
    step = opt.state[leaves[0]]["step"] if leaves else 0
    return {"m": moment("m"), "v": moment("v"),
            "step": torch.tensor(step, dtype=torch.int32)}


def run(args) -> dict:
    """Train as the flags say.  Returns the params, the config, the step
    function and the batches (another step is ``step_fn(params,
    batches[i])``) and, a step each, the loss and grad norm (floats), the
    seconds (ending in a synchronise on the card) and the kernel launches
    (``ops.launch_counts`` moved by the step)."""
    dev = D.resolve(args.device)
    cfg = config(args)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = M.init_params(cfg, gen, max_seq=args.seq, device=dev)
    n_params = M.param_count(params)
    print(f"arch={cfg.name} family={cfg.family} params={n_params:,} "
          f"devices=1 device={dev}")

    opt = AdamW(M.trainable(params),
                lr=cosine_schedule(args.lr, args.warmup, args.steps),
                weight_decay=0.01)
    # no per-layer recompute, as the reference's launcher
    step_fn = M.make_train_step(cfg, opt, remat=False)

    ds = SyntheticLMDataset(cfg.vocab_size, args.seq, seed=args.seed)
    it = ds.batches(args.batch)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
               for _ in range(args.steps)]
    tokens_per_step = args.batch * args.seq

    out = {"params": params, "cfg": cfg, "step_fn": step_fn,
           "batches": batches, "losses": [], "grad_norms": [],
           "step_seconds": [], "step_launches": []}
    t0 = time.time()
    loss = float("nan")
    for step, batch in enumerate(batches, start=1):
        before = ops.launch_counts()
        ts = time.perf_counter()
        metrics = step_fn(params, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["step_seconds"].append(time.perf_counter() - ts)
        after = ops.launch_counts()
        out["step_launches"].append({k: n - before[k] for k, n in after.items()
                                     if n != before[k]})
        loss = float(metrics["loss"])
        out["losses"].append(loss)
        out["grad_norms"].append(float(metrics["grad_norm"]))
        if step % args.log_every == 0 or step == 1:
            tps = step * tokens_per_step / (time.time() - t0)
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {out['grad_norms'][-1]:.3f} "
                  f"tok/s {tps:,.0f}", flush=True)
        if args.ckpt_dir and step % args.ckpt_every == 0:
            path = save_checkpoint(args.ckpt_dir, step,
                                   {"params": params,
                                    "opt": opt_state(params, opt)},
                                   meta={"arch": cfg.name, "loss": loss})
            print(f"  checkpoint -> {path}")
    print(f"done in {time.time() - t0:.1f}s; final loss {loss:.4f}")
    return out


def main(argv=None):
    return run(parse_args(argv))["params"]


if __name__ == "__main__":
    main()
