"""The port's crash-safe checkpoints (``repro_torch.checkpoint``): the
reference's invariants (``tests/test_checkpoint.py``) on trees of tensors
— a kill at any point during save never corrupts resume, partial
directories are skipped and rejected, the manifest is validated against
the npz payload before any leaf is restored — plus bitwise round trips
of bf16 leaves and of a GNN model through ``restore_params``."""
import ast
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.models.gnn import model as GM
from repro_torch.serving import restore_params


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "w": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32)),
        "b": torch.from_numpy(rng.normal(size=(3,)).astype(np.float32)),
        "inner": {"scale": torch.tensor(float(seed), dtype=torch.float64)},
    }


def _assert_tree_equal(a, b):
    for key in ("w", "b"):
        assert torch.equal(a[key], b[key]), key
    assert torch.equal(a["inner"]["scale"], b["inner"]["scale"])


# ---------------------------------------------------------------------------
# happy path: roundtrip, meta, dtype restoration
# ---------------------------------------------------------------------------

def test_roundtrip_with_meta(tmp_path):
    t = _tree(0)
    path = save_checkpoint(str(tmp_path), 3, t,
                           meta={"params_version": 3, "note": "x"})
    assert path.endswith("step_00000003")
    assert latest_step(str(tmp_path)) == 3
    restored, manifest = load_checkpoint(str(tmp_path), _tree(99))
    _assert_tree_equal(restored, t)
    assert manifest["meta"] == {"params_version": 3, "note": "x"}
    assert manifest["step"] == 3
    # leaves flattened in sorted key-path order, as jax orders dict keys
    assert manifest["paths"] == [["b"], ["inner", "scale"], ["w"]]


def test_restore_casts_to_saved_dtype(tmp_path):
    """The manifest dtype (what was saved) wins over the template's."""
    t = _tree(1)
    save_checkpoint(str(tmp_path), 0, t)
    template = {"w": torch.zeros((4, 3), dtype=torch.float16),
                "b": torch.zeros((3,), dtype=torch.float16),
                "inner": {"scale": torch.tensor(0, dtype=torch.int32)}}
    restored, _ = load_checkpoint(str(tmp_path), template)
    assert restored["w"].dtype == torch.float32
    assert restored["inner"]["scale"].dtype == torch.float64
    _assert_tree_equal(restored, t)


def test_overwrite_same_step_is_atomic(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree(0))
    t2 = _tree(7)
    save_checkpoint(str(tmp_path), 1, t2)
    restored, _ = load_checkpoint(str(tmp_path), _tree(99))
    _assert_tree_equal(restored, t2)
    assert latest_step(str(tmp_path)) == 1


# ---------------------------------------------------------------------------
# kill mid-save: the partial step is invisible, resume uses the previous
# ---------------------------------------------------------------------------

def test_kill_mid_save_resumes_previous_step(tmp_path, monkeypatch):
    """A crash after both files are staged but before the publishing
    rename: only the .tmp staging dir remains, step_2 is never
    published, and resume lands on step 1."""
    good = _tree(0)
    save_checkpoint(str(tmp_path), 1, good)

    def crash_rename(*a, **k):
        raise KeyboardInterrupt("killed mid-save")

    with monkeypatch.context() as m:
        m.setattr(os, "rename", crash_rename)
        with pytest.raises(KeyboardInterrupt):
            save_checkpoint(str(tmp_path), 2, _tree(1))

    assert not os.path.isdir(tmp_path / "step_00000002")
    assert os.path.isdir(tmp_path / "step_00000002.tmp")
    assert latest_step(str(tmp_path)) == 1
    restored, manifest = load_checkpoint(str(tmp_path), _tree(99))
    _assert_tree_equal(restored, good)
    assert manifest["step"] == 1

    # a retry after the crash reuses (and replaces) the stale staging dir
    t2 = _tree(2)
    save_checkpoint(str(tmp_path), 2, t2)
    assert latest_step(str(tmp_path)) == 2
    assert not os.path.isdir(tmp_path / "step_00000002.tmp")
    restored, _ = load_checkpoint(str(tmp_path), _tree(99))
    _assert_tree_equal(restored, t2)


def test_partial_dir_skipped_and_rejected(tmp_path):
    """A torn step (one file missing) is skipped by latest_step and
    rejected by an explicit load."""
    save_checkpoint(str(tmp_path), 1, _tree(0))
    save_checkpoint(str(tmp_path), 5, _tree(1))
    os.remove(tmp_path / "step_00000005" / "arrays.npz")
    assert latest_step(str(tmp_path)) == 1
    with pytest.raises(FileNotFoundError, match="partial"):
        load_checkpoint(str(tmp_path), _tree(99), step=5)
    restored, _ = load_checkpoint(str(tmp_path), _tree(99))
    _assert_tree_equal(restored, _tree(0))


def test_empty_and_missing_dirs(tmp_path):
    assert latest_step(str(tmp_path)) is None
    assert latest_step(str(tmp_path / "nope")) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), _tree(0))


def test_tmp_only_dir_is_never_a_candidate(tmp_path):
    """A directory holding ONLY a ``.tmp`` staging step — a kill before
    the very first publish rename — looks empty, even when the stage
    holds both files: latest_step returns None and load/restore raise."""
    src = tmp_path / "src"
    save_checkpoint(str(src), 3, _tree(0), meta={"params_version": 1})
    ckpts = tmp_path / "ckpts"
    ckpts.mkdir()
    shutil.move(str(src / "step_00000003"),
                str(ckpts / "step_00000003.tmp"))
    assert latest_step(str(ckpts)) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(ckpts), _tree(0))
    with pytest.raises(FileNotFoundError):
        restore_params(str(ckpts), torch.nn.Linear(3, 4))


# ---------------------------------------------------------------------------
# manifest validation
# ---------------------------------------------------------------------------

def test_manifest_npz_key_mismatch_rejected(tmp_path):
    """A manifest declaring more leaves than the npz holds (torn copy)
    fails loudly before any leaf is restored."""
    save_checkpoint(str(tmp_path), 0, _tree(0))
    mpath = tmp_path / "step_00000000" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["num_leaves"] += 1
    manifest["paths"].append(["extra"])
    manifest["shapes"].append([2])
    manifest["dtypes"].append("float32")
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="missing"):
        load_checkpoint(str(tmp_path), _tree(0))


def test_template_leaf_count_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 0, _tree(0))
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(str(tmp_path),
                        {"only": torch.zeros((4, 3), dtype=torch.float32)})


def test_template_key_paths_must_match(tmp_path):
    """Same leaf count, other names: a wrong model is refused, not loaded
    into the wrong slots."""
    save_checkpoint(str(tmp_path), 0, _tree(0))
    other = {"w": torch.zeros(4, 3), "b": torch.zeros(3),
             "renamed": {"scale": torch.tensor(0.0)}}
    with pytest.raises(ValueError, match="paths"):
        load_checkpoint(str(tmp_path), other)


# ---------------------------------------------------------------------------
# what the port adds: bf16 bits, models, no msgpack
# ---------------------------------------------------------------------------

def test_bf16_leaf_round_trips_bitwise(tmp_path):
    g = torch.Generator().manual_seed(3)
    x = (torch.randn(5, 7, generator=g) * 1e3).to(torch.bfloat16)
    x[0, :4] = torch.tensor([0.0, -0.0, float("inf"), 1e-40]).to(x.dtype)
    save_checkpoint(str(tmp_path), 0, {"x": x, "y": x.float()})
    _, manifest = load_checkpoint(str(tmp_path), {"x": x, "y": x})
    assert manifest["dtypes"] == ["bfloat16", "float32"]
    out, _ = load_checkpoint(str(tmp_path),
                             {"x": torch.zeros(5, 7), "y": torch.zeros(5, 7)})
    assert out["x"].dtype == torch.bfloat16
    assert torch.equal(out["x"].view(torch.int16), x.view(torch.int16))
    assert torch.equal(out["y"], x.float())


@pytest.mark.parametrize("arch", ["sage", "gat", "ggnn"])
def test_gnn_state_dict_round_trips_through_restore_params(tmp_path, arch):
    cfg = GM.GNNConfig(arch=arch, feat_dim=12, hidden=16, num_classes=4)
    saved = GM.init_gnn(cfg, torch.Generator().manual_seed(1), device="cpu")
    save_checkpoint(str(tmp_path), 5, {"params": saved.state_dict()},
                    meta={"params_version": 5})
    template = GM.init_gnn(cfg, torch.Generator().manual_seed(2),
                           device="cpu")
    before = {k: v.clone() for k, v in template.state_dict().items()}
    restored, version = restore_params(str(tmp_path), template)
    assert version == 5 and restored is not template
    got, want = restored.state_dict(), saved.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert torch.equal(got[k], want[k]), k
    # the template is left as it was
    for k, v in template.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_checkpoint_imports_no_msgpack():
    for mod in (ckpt_io, __import__("repro_torch.checkpoint",
                                    fromlist=["x"])):
        tree = ast.parse(open(mod.__file__, encoding="utf-8").read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        assert not [m for m in names if m.split(".")[0] == "msgpack"], names
