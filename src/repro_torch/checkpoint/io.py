"""Checkpointing: nested dicts of tensors with a JSON dtype/shape manifest.

Layout (one directory per step):
  <dir>/step_<n>/manifest.json   — leaf key paths, shapes, dtypes, meta
  <dir>/step_<n>/arrays.npz      — the leaves, copied to the host

A tree is a nested dict (or list) whose leaves are tensors, such as
``{"params": module.state_dict()}`` or the transformer's params with
their lists of layers.  Leaves are flattened in sorted key-path order,
the order ``jax.tree_util`` gives dict keys (a list's items in order,
keyed by their index), and the manifest records each leaf's key path.
bf16 leaves are stored as their
``uint16`` bits under the manifest dtype ``"bfloat16"`` and round-trip
bitwise; every other dtype is stored as numpy stores it.

Crash safety: ``save_checkpoint`` stages both files in a ``step_<n>.tmp``
sibling and publishes with one ``os.rename`` — a process killed mid-write
leaves at most a ``.tmp`` directory that the step regex never matches, so
``latest_step`` can only ever select a fully written step.  A
``step_<n>/`` directory missing either file (a torn copy) is skipped by
``latest_step`` and rejected by ``load_checkpoint``, and the manifest's
``num_leaves`` is validated against the npz keys before any leaf is
touched.

Not a distributed checkpointer (no per-shard files); the interface is
``save_checkpoint(dir, step, tree)`` / ``load_checkpoint(dir, template,
step?)``, as in the reference.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"step_(\d+)$")
_REQUIRED = ("manifest.json", "arrays.npz")
_BF16 = "bfloat16"


def _flatten(tree, prefix=()) -> List[Tuple[tuple, object]]:
    """``(key path, leaf)`` pairs of a nested dict (keys sorted per level)
    or list (items in order, keyed by index)."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], prefix + (k,))
        return out
    if isinstance(tree, list):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + (i,))
        return out
    return [(prefix, tree)]


def _unflatten(template, leaves: dict, prefix=()):
    if isinstance(template, dict):
        return {k: _unflatten(v, leaves, prefix + (k,))
                for k, v in template.items()}
    if isinstance(template, list):
        return [_unflatten(v, leaves, prefix + (i,))
                for i, v in enumerate(template)]
    return leaves[prefix]


def _to_host(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """One leaf as a host array and its manifest dtype name."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    a = t.numpy()
    return a, str(a.dtype)


def _is_complete(path: str) -> bool:
    """A checkpoint directory is loadable iff both files are present."""
    return all(os.path.isfile(os.path.join(path, f)) for f in _REQUIRED)


def save_checkpoint(directory: str, step: int, tree, *,
                    meta: Optional[dict] = None) -> str:
    """Write one step atomically: stage into ``step_<n>.tmp`` then publish
    via ``os.rename`` (same filesystem, so the step directory appears all
    at once).  ``meta`` must be JSON-serialisable.  Returns the final
    step path."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(directory, exist_ok=True)
    if os.path.isdir(tmp):            # stale staging dir from a prior crash
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = _flatten(tree)
    # every leaf reaches the host here, before np.savez sees it
    host = [_to_host(leaf) for _, leaf in flat]
    manifest = {
        "paths": [list(p) for p, _ in flat],
        "num_leaves": len(host),
        "shapes": [list(a.shape) for a, _ in host],
        "dtypes": [dt for _, dt in host],
        "step": step,
        "meta": meta or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w",
              encoding="utf-8") as f:
        json.dump(manifest, f)
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
    if os.path.isdir(final):          # overwrite = replace atomically too
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    """Newest step with BOTH files present (partial/torn dirs are not
    candidates — resume after a kill-mid-save lands on the previous
    step).  ``.tmp`` staging dirs never match the step pattern."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := _STEP_RE.match(d))
             and _is_complete(os.path.join(directory, d))]
    return max(steps) if steps else None


def _restore(a: np.ndarray, dtype: str, like: torch.Tensor) -> torch.Tensor:
    """One saved array in its saved dtype, shaped as ``like`` and on
    ``like``'s device."""
    if dtype == _BF16:
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.asarray(a, dtype=np.dtype(dtype)))
    return t.reshape(like.shape).to(like.device)


def load_checkpoint(directory: str, template, step: Optional[int] = None):
    """Restore into the structure of ``template`` (shapes must match).

    Leaves come back in the dtype recorded in the manifest (the dtype
    that was saved — not the template's), on the template leaf's device.
    Returns ``(tree, manifest)``.  Raises ``FileNotFoundError`` for
    absent/partial steps and ``ValueError`` when the manifest disagrees
    with the npz contents or the template structure."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    if not _is_complete(path):
        raise FileNotFoundError(
            f"checkpoint {path} is missing or partial "
            f"(needs {' + '.join(_REQUIRED)})")
    with open(os.path.join(path, "manifest.json"), encoding="utf-8") as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        n = manifest["num_leaves"]
        missing = [f"leaf_{i}" for i in range(n)
                   if f"leaf_{i}" not in data.files]
        if missing:
            raise ValueError(
                f"checkpoint {path} manifest declares {n} leaves but "
                f"arrays.npz is missing {missing[:3]}"
                f"{'...' if len(missing) > 3 else ''}")
        arrays = [data[f"leaf_{i}"] for i in range(n)]
    flat = _flatten(template)
    if len(flat) != len(arrays):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, template {len(flat)}")
    saved = [tuple(p) for p in manifest["paths"]]
    if saved != [p for p, _ in flat]:
        raise ValueError(f"checkpoint leaf paths {saved[:3]}... differ "
                         f"from the template's {[p for p, _ in flat][:3]}...")
    leaves = {p: _restore(a, dt, like) for (p, like), a, dt
              in zip(flat, arrays, manifest["dtypes"])}
    return _unflatten(template, leaves), manifest
