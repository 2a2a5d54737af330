"""The port's transformer trainer against the reference's JAX functions,
on identical numpy inputs and parameters (``params_from_numpy``), at the
reduced configs in float32: the synthetic corpus (bitwise), ``loss_fn``
and one step's gradients for every family (``jax.value_and_grad`` of
``src/repro/models/transformer/model.py:300``), the training launcher
(its log lines, the families it refuses, its checkpoint) and the two
examples on the CPU.  The 10-step optimizer runs are in
``test_torch_lm_train_steps.py``.

On the CPU the port runs the plain versions of K7 and K8 (autograd
differentiates them); the card's backward kernels are held against those
by ``chip_smoke.py`` (phase 20).  Tolerance: 1e-5 of each tensor's
largest reference value (float32 sums in another order).
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_base
from repro.data import pipeline as RP
from repro.models.transformer import model as RM
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import base
from repro_torch.data import pipeline as P
from repro_torch.examples import train_lm_100m, whisper_vlm_smoke
from repro_torch.launch import train as T
from repro_torch.models.transformer import model as M

REL = 1e-5
B, S = 2, 32
# each family the reference's model takes, at its reduced config
FAMILIES = {"qwen2.5-14b": "dense", "phi3-mini-3.8b": "dense",
            "gemma-7b": "dense", "glm4-9b": "dense",
            "granite-moe-1b-a400m": "moe", "deepseek-v3-671b": "mla_moe",
            "mamba2-780m": "ssm", "zamba2-2.7b": "hybrid",
            "whisper-tiny": "encdec", "qwen2-vl-7b": "vlm"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max()) if want.size else 0.0
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * (scale or 1.0), f"{what}: {err} > {rel} x {scale}"


def stacked(tree):
    """A port param (or gradient) tree in the reference's layout: each
    list of layers stacked along a leading axis, numpy leaves."""
    if isinstance(tree, dict):
        return {k: stacked(v) for k, v in tree.items()}
    if isinstance(tree, list):
        items = [stacked(t) for t in tree]
        return jax.tree.map(lambda *xs: np.stack(xs), *items)
    return tree.detach().float().numpy()


def assert_trees_close(got, want, rel=REL, rel_by_path=None):
    """Leaf by leaf (by key path) within ``rel`` (or ``rel_by_path``'s
    bound for a leaf it names, by ``jax.tree_util.keystr``) of each
    reference leaf's largest value."""
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert sorted(map(str, got)) == sorted(str(p) for p, _ in want)
    by_name = {str(p): v for p, v in got.items()}
    for path, w in want:
        name = jax.tree_util.keystr(path)
        _close(by_name[str(path)], w, (rel_by_path or {}).get(name, rel),
               name)


def family_batch(cfg, seed=0):
    """A training batch for ``cfg``'s family as numpy: the corpus's tokens
    and labels, and for encdec / vlm the stub frontend's embeddings
    (normal) with M-RoPE's text-style positions."""
    b = next(P.SyntheticLMDataset(cfg.vocab_size, S, seed=seed).batches(B))
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        b["enc_embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    elif cfg.family == "vlm":
        b = {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32), "labels": b["labels"],
            "positions": np.broadcast_to(np.arange(S, dtype=np.int32)[
                None, None], (3, B, S)).copy()}
    return b


def reference_model(arch):
    """The reference's reduced config and params, and the port's holding
    the same values."""
    rcfg = ref_base.get_config(arch).reduced()
    cfg = base.get_config(arch).reduced()
    tree = jax.tree.map(np.asarray, RM.init_params(
        rcfg, jax.random.PRNGKey(0), max_seq=S))
    return rcfg, tree, cfg, M.params_from_numpy(cfg, tree, device="cpu")


# ---------------------------------------------------------------------------
# the corpus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,seed,batch", [
    (512, 32, 0, 2), (8192, 192, 0, 4), (1000, 17, 3, 5)])
def test_synthetic_batches_equal_the_reference(vocab, seq, seed, batch):
    """Three batches of the corpus, bit for bit, and its unigram."""
    mine = P.SyntheticLMDataset(vocab, seq, seed=seed)
    ref = RP.SyntheticLMDataset(vocab, seq, seed=seed)
    np.testing.assert_array_equal(mine.unigram, ref.unigram)
    np.testing.assert_array_equal(mine.next_tok, ref.next_tok)
    for a, b in zip((next(mine.batches(batch)) for _ in range(3)),
                    (next(ref.batches(batch)) for _ in range(3))):
        assert sorted(a) == sorted(b) == ["labels", "tokens"]
        for k in a:
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_batch_iterator_and_the_entropy_floor():
    cfg, rcfg = base.get_config("mamba2-780m"), \
        ref_base.get_config("mamba2-780m")
    a = next(P.batch_iterator(cfg, 2, 16, seed=4))
    b = next(RP.batch_iterator(rcfg, 2, 16, seed=4))
    for k in b:
        np.testing.assert_array_equal(a[k], b[k])
    # the reference example's floor, computed as it prints it
    ranks = np.arange(1, 8192 + 1)
    p = (1 / ranks) / np.sum(1 / ranks)
    assert P.unigram_entropy(8192) == pytest.approx(
        -np.sum(p * np.log(p)), rel=1e-12)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_loss_and_gradients_match_the_reference(arch):
    """``loss_fn`` and the gradient of every parameter against the
    reference's ``loss_fn`` under ``jax.value_and_grad``."""
    rcfg, tree, cfg, params = reference_model(arch)
    assert cfg.family == FAMILIES[arch]
    batch = family_batch(cfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(rcfg, p, b, remat=False)))(
            jax.tree.map(jnp.asarray, tree),
            {k: jnp.asarray(v) for k, v in batch.items()})
    M.trainable(params)
    loss = M.loss_fn(cfg, params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    loss.backward()
    _close(loss.item(), float(want_loss), what="loss")
    # a leaf the loss does not reach (vlm's token table, an expert no
    # token chose) has no .grad, where JAX gives zeros
    grads = M._map(lambda p, _: p.grad if p.grad is not None
                   else torch.zeros_like(p), params, params)
    assert_trees_close(stacked(grads), want_grads)


def test_train_step_reports_the_grad_norm_before_clipping():
    """``make_train_step``: the loss before the update, the global norm of
    the float32 gradients (as the reference's train step), and one step
    of the optimizer it was given (SGD at lr 1 moves the parameters by
    the gradient itself)."""
    _, _, cfg, params = reference_model("phi3-mini-3.8b")
    batch = {k: torch.from_numpy(v) for k, v in family_batch(cfg).items()}
    before = [p.detach().clone() for p in M.trainable(params)]
    loss = M.loss_fn(cfg, params, batch)
    grads = torch.autograd.grad(loss, M.trainable(params))
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    from repro_torch.optim import Sgd
    step = M.make_train_step(cfg, Sgd(M.trainable(params), lr=1.0))
    m = step(params, batch)
    assert m["loss"].item() == pytest.approx(loss.item(), rel=1e-6)
    assert m["grad_norm"].item() == pytest.approx(norm.item(), rel=1e-5)
    moved = torch.sqrt(sum(torch.sum((p.detach() - b) ** 2) for p, b in
                           zip(M.trainable(params), before)))
    assert moved.item() == pytest.approx(norm.item(), rel=1e-4)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_logs_checkpoints_and_returns_the_params(tmp_path, capsys):
    """``launch.train.main`` at a reduced config on the CPU: the
    reference's log lines, a checkpoint of the params and AdamW's state
    that loads back equal, and the params returned."""
    ckpt = tmp_path / "ck"
    params = T.main(["--arch", "qwen2.5-14b", "--reduced", "--steps", "4",
                     "--batch", "2", "--seq", "32", "--log-every", "2",
                     "--ckpt-dir", str(ckpt), "--ckpt-every", "4",
                     "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"arch=qwen2\.5-14b family=dense params=[\d,]+ "
                        r"devices=1 device=cpu", lines[0])
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert [int(ln.split()[1]) for ln in steps] == [1, 2, 4]
    for ln in steps:
        assert re.fullmatch(r"step +\d+ loss \d+\.\d{4} gnorm \d+\.\d{3} "
                            r"tok/s [\d,]+", ln), ln
    assert lines[-2].startswith("  checkpoint -> ")
    assert re.fullmatch(r"done in \d+\.\d+s; final loss \d+\.\d{4}",
                        lines[-1])
    template = {"params": params, "opt": {
        "m": params, "v": params, "step": torch.zeros((), dtype=torch.int32)}}
    tree, manifest = load_checkpoint(str(ckpt), template)
    assert manifest["step"] == 4 and manifest["meta"]["arch"] == \
        "qwen2.5-14b"
    for a, b in zip(M._leaves(tree["params"]), M._leaves(params)):
        assert torch.equal(a, b.detach())
    assert int(tree["opt"]["step"]) == 4
    assert all(m.dtype == torch.float32 and m.abs().sum() > 0
               for m in M._leaves(tree["opt"]["v"]))


@pytest.mark.parametrize("arch", ["whisper-tiny", "qwen2-vl-7b"])
def test_launcher_refuses_the_frontend_families(arch):
    with pytest.raises(SystemExit, match="precomputed frontend"):
        T.main(["--arch", arch, "--reduced", "--steps", "1",
                "--device", "cpu"])


def test_launcher_overrides_and_the_card_default():
    """``--d-model`` sets head_dim = d_model // num_heads (train_lm_100m's
    (192, 192) heads); ``--device`` defaults to the card, which a machine
    without one refuses."""
    cfg = T.config(T.parse_args(["--arch", "qwen2.5-14b", "--reduced",
                                 "--layers", "12", "--d-model", "768",
                                 "--d-ff", "2304", "--vocab", "8192"]))
    assert (cfg.num_layers, cfg.d_model, cfg.resolved_head_dim, cfg.d_ff,
            cfg.vocab_size) == (12, 768, 192, 2304, 8192)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.main(["--arch", "qwen2.5-14b", "--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def test_train_lm_100m_on_the_cpu(capsys):
    """Two steps of the ~100M-parameter example, and its floor."""
    out = train_lm_100m.main(["--steps", "2", "--device", "cpu"])
    assert len(out["losses"]) == 2 and np.all(np.isfinite(out["losses"]))
    assert M.param_count(out["params"]) == 97_555_200
    assert "unigram entropy floor: 6.487 nats" in capsys.readouterr().out


def test_whisper_vlm_smoke_on_the_cpu():
    """Ten steps of each family, the loss falling, then a decode step."""
    out = whisper_vlm_smoke.main(["--device", "cpu"])
    for arch in whisper_vlm_smoke.ARCHS:
        assert out[arch]["losses"][-1] < out[arch]["losses"][0]
        assert out[arch]["decode_logits_shape"] == (whisper_vlm_smoke.B,
                                                    512)
