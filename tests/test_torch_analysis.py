"""Tests for ``repro_torch.analysis``, the port's linter.

Each rule of the port fires on its bad fixture (at exactly the lines
listed) and is silent on its clean one (``tests/fixtures/analysis_torch``,
and the reference's ``tests/fixtures/analysis`` for the rules the two
linters share); on the shared rules and the engine (RL000, RL003, RL005
less the rows with no counterpart, RL006) its findings equal
``repro.analysis``'s, ``(rule, line)`` for ``(rule, line)``, on those
fixtures and on ``src/repro_torch``.  Mutation tests put each bug class
back into a copy of a real file of the port; the CLI and the clean tree
are covered end to end, and so are the raw kernel wrappers' refusals
that RL007 asks for.
"""
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.analysis as ref
from repro.analysis.rules.telemetry_drift import \
    TelemetryCatalogRule as RefCatalogRule
from repro_torch import analysis as port
from repro_torch.analysis.rules.telemetry_drift import (
    NO_COUNTERPART, TelemetryCatalogRule)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "fixtures", "analysis_torch")
REF_FIXTURES = os.path.join(HERE, "fixtures", "analysis")
PORT_SRC = os.path.join(REPO, "src", "repro_torch")
# the fixture corpora are excluded from real runs by default; the tests
# lint them on purpose, so drop that exclude (keep __pycache__)
FIXTURE_EXCLUDES = ("__pycache__",)


def lint(paths, select=None, root=FIXTURES, module=port):
    engine = module.LintEngine(module.build_rules(REPO, select=select),
                               root=root, excludes=FIXTURE_EXCLUDES)
    return engine.run(paths)


def where(findings):
    return sorted((f.rule, f.line) for f in findings)


# ---------------------------------------------------------------------------
# per rule: the bad fixture's exact lines, and a clean fixture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rule_id,bad,lines,clean", [
    # loss through a local function, through the slice, dist.nn in grad
    ("RL001", "rl001_bad.py", [17, 27, 34], "rl001_clean.py"),
    # compile decorator, compile call via a helper, graph capture, graphed
    ("RL002", "rl002_bad.py", [10, 16, 28, 33], "rl002_clean.py"),
    ("RL003", os.path.join(REF_FIXTURES, "rl003_bad.py"), [13, 21],
     os.path.join(REF_FIXTURES, "rl003_clean.py")),
    # (a) no opt-in, (b) dropped opt-in and its (a), (c) unread, (d) bounds
    ("RL004", "rl004_bad.cu", [16, 22, 23, 28, 37], "rl004_clean.cu"),
    ("RL006", os.path.join(REF_FIXTURES, "rl006_bad.py"), [6, 7],
     os.path.join(REF_FIXTURES, "rl006_clean.py")),
    # no refusal, late, conditional, through a helper
    ("RL007", os.path.join("kernels", "rl007_bad.py"), [9, 16, 23, 35],
     os.path.join("kernels", "rl007_clean.py")),
    # a probe, an except falling back to plain, to the CPU
    ("RL008", "rl008_bad.py", [9, 18, 25], "rl008_clean"),
])
def test_rule_fires_on_bad_and_passes_clean(rule_id, bad, lines, clean):
    res = lint([os.path.join(FIXTURES, bad)], select=[rule_id])
    assert where(res.findings) == [(rule_id, n) for n in lines], \
        res.format_human()
    assert res.exit_code == 1
    res = lint([os.path.join(FIXTURES, clean)], select=[rule_id])
    assert res.findings == [] and res.files_checked >= 1, \
        res.format_human()


def test_rl004_names_each_form():
    res = lint([os.path.join(FIXTURES, "rl004_bad.cu")], select=["RL004"])
    msgs = {f.line: f.message for f in res.findings}
    assert "no checked `cudaFuncSetAttribute(big_kernel" in msgs[16]
    assert "result is dropped" in msgs[22]
    assert "reads `cudaGetLastError()`" in msgs[28]
    assert "512 threads a block, above its __launch_bounds__(256)" in msgs[37]


def test_cuda_blanking_keeps_lines_and_drops_comments_strings():
    from repro_torch.analysis.rules import cuda_launch as CL
    src = ('#define M(x) \\\n  x<<<1, 2>>>()\n'
           '// a<<<1, 1>>>()\nint f() { const char* s = "k<<<1, 1>>>"; '
           "return 0; }\n")
    code = CL.blank_noncode(src)
    assert code.count("\n") == src.count("\n") and len(code) == len(src)
    assert "<<<" not in code
    assert [f.name for f in CL.functions(code)] == ["f"]


# ---------------------------------------------------------------------------
# the shared rules and the engine against repro.analysis
# ---------------------------------------------------------------------------

SHARED = ["RL003", "RL006"]


@pytest.mark.parametrize("name", [
    "rl003_bad.py", "rl003_clean.py", "rl006_bad.py", "rl006_clean.py",
    "suppress_bare.py", "suppress_justified.py"])
def test_shared_rules_and_suppressions_match_the_reference(name):
    path = os.path.join(REF_FIXTURES, name)
    mine = lint([path], select=SHARED, root=REPO)
    theirs = lint([path], select=SHARED, root=REPO, module=ref)
    assert where(mine.findings) == where(theirs.findings)
    assert where(mine.suppressed) == where(theirs.suppressed)
    assert mine.exit_code == theirs.exit_code
    assert mine.files_checked == theirs.files_checked == 1


@pytest.mark.parametrize("tree", ["rl005_bad", "rl005_clean"])
def test_rl005_matches_the_reference_on_its_fixtures(tree):
    root = os.path.join(REF_FIXTURES, tree)
    doc = os.path.join(root, "docs", "observability.md")
    runs = [m.LintEngine([rule(doc_path=doc)], root=root,
                         excludes=FIXTURE_EXCLUDES).run(
                             [os.path.join(root, "src")])
            for m, rule in ((port, TelemetryCatalogRule),
                            (ref, RefCatalogRule))]
    assert where(runs[0].findings) == where(runs[1].findings)
    assert (runs[0].exit_code == 1) == (tree == "rl005_bad")


def test_rl000_rl003_rl005_rl006_match_the_reference_on_the_port():
    """On ``src/repro_torch`` the reference's catalog rule reports the
    three rows of the TPU capacity dispatch, which the port lists in
    NO_COUNTERPART; everything else is equal, and both are clean."""
    select = ["RL003", "RL005", "RL006"]
    mine = lint([PORT_SRC], select=select, root=REPO)
    theirs = lint([PORT_SRC], select=select, root=REPO, module=ref)
    excluded = [f for f in theirs.findings
                if any(f"`{n}`" in f.message for n in NO_COUNTERPART)]
    assert sorted(re.search(r"`(\w+)`", f.message).group(1)
                  for f in excluded) == sorted(NO_COUNTERPART)
    rest = [f for f in theirs.findings if f not in excluded]
    assert where(mine.findings) == where(rest) == []
    assert mine.files_checked == theirs.files_checked


def test_rl005_flags_a_registered_name_listed_without_counterpart(tmp_path):
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "observability.md").write_text(
        "## Metric catalog\n\n| metric | kind |\n| --- | --- |\n"
        "| `kernel_dispatch_total` | counter |\n")
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "m.py").write_text(
        "from repro_torch.core import telemetry\n"
        "C = telemetry.counter('kernel_dispatch_total', 'x')\n")
    res = port.LintEngine(
        [TelemetryCatalogRule(str(tmp_path / "docs" / "observability.md"))],
        root=str(tmp_path)).run([str(tmp_path / "src")])
    assert where(res.findings) == [("RL005", 2)]
    assert "NO_COUNTERPART" in res.findings[0].message


@pytest.mark.parametrize("comment,suppressed", [
    ("// repro-lint: disable=RL004 -- fixture: the justified path", True),
    ("// repro-lint: disable=RL004", False),
    ("# repro-lint: disable=RL004 -- a Python comment does not count", False),
])
def test_cuda_suppressions(tmp_path, comment, suppressed):
    """A CUDA source is silenced by a justified ``//`` comment on the line
    or the one above; a bare one silences nothing and is RL000."""
    lines = open(os.path.join(FIXTURES, "rl004_bad.cu"),
                 encoding="utf-8").read().splitlines()
    lines.insert(36, "  " + comment)         # above launch_d's launch
    path = tmp_path / "k.cu"
    path.write_text("\n".join(lines) + "\n")
    shutil.copy(os.path.join(FIXTURES, "rl004_bounds.cuh"), tmp_path)
    res = lint([str(path)], select=["RL004"], root=str(tmp_path))
    rules = where(res.findings)
    if suppressed:
        assert where(res.suppressed) == [("RL004", 38)]
        assert ("RL004", 38) not in rules and ("RL000", 37) not in rules
    else:
        assert res.suppressed == [] and ("RL004", 38) in rules
        assert (("RL000", 37) in rules) == comment.startswith("//")


def test_finding_json_round_trip_and_format():
    f = port.Finding("RL007", "a/b.py", 17, "msg with `ticks`")
    assert port.Finding.from_dict(json.loads(json.dumps(f.to_dict()))) == f
    assert f.format() == "a/b.py:17: error RL007 msg with `ticks`"


# ---------------------------------------------------------------------------
# mutation tests on copies of the port's real files
# ---------------------------------------------------------------------------

LOSS = "return torch.sum((logz - gold) * shard.label_mask) / cnt"
SET_ATTR_CHECK = "  if (e != cudaSuccess) return (int)e;\n"
K7_OPT_IN = ("  const cudaError_t e = cudaFuncSetAttribute(\n"
             "      flash_fwd_wgmma_kernel<HD, HDV>, "
             "cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);\n"
             "  if (e != cudaSuccess) return (int)e;\n")
K7_REFUSAL = ('    _refuse_grad("flash_attention_cuda (K7)",\n'
              '                 "kernels.flash_attention.FlashAttention", '
              'q, k, v)\n')
PICK = ('    """The kernel wrapper for a CUDA tensor, the plain version for a '
        'CPU\n    tensor; any other device raises.  Nothing falls back."""\n')


@pytest.mark.parametrize("rule_id,rel,old,new,count,want", [
    # the double reduction: the loss all-gathered inside the loss
    ("RL001", "core/propagation.py", LOSS,
     "return C.AllGather.apply((torch.sum((logz - gold) * "
     "shard.label_mask) / cnt).reshape(1)).sum()", 1,
     ["`C.AllGather.apply` is reachable (via `local_loss`)"]),
    # ssd_chunk_bwd.cu's tile opt-in no longer checked: (b) and (a)
    ("RL004", "kernels/csrc/ssd_chunk_bwd.cu", SET_ATTR_CHECK, "", 1,
     ["result is dropped", "no checked `cudaFuncSetAttribute("
      "ssd_bwd_wgmma_kernel<T,N>"]),
    # K7's bf16 launch without its opt-in
    ("RL004", "kernels/csrc/flash_attention.cu", K7_OPT_IN, "", 1,
     ["no checked `cudaFuncSetAttribute(flash_fwd_wgmma_kernel<HD,HDV>"]),
    # K7's raw forward without its refusal
    ("RL007", "kernels/flash_attention.py", K7_REFUSAL, "", 1,
     ["`flash_attention_cuda` reaches a kernel launch"]),
    # pick falls back to the plain version when there is no card
    ("RL008", "kernels/segment_sum.py", PICK,
     PICK + "    if not torch.cuda.is_available():\n"
            "        return plain_fn\n", 1,
     ["`torch.cuda.is_available()` outside `device.resolve`"]),
])
def test_mutation_fires_and_original_is_clean(tmp_path, rule_id, rel, old,
                                              new, count, want):
    """The mutated copy fires its rule with the expected messages (the
    copy keeps its directory, so RL007's ``kernels`` scope and RL004's
    local headers hold); the unmutated original is clean under it."""
    src = os.path.join(PORT_SRC, rel)
    text = open(src, encoding="utf-8").read()
    assert text.count(old) >= count, f"mutation anchor moved in {rel}"
    shutil.copytree(os.path.dirname(src),
                    tmp_path / os.path.dirname(rel),
                    ignore=shutil.ignore_patterns("__pycache__"))
    mutant = tmp_path / rel
    mutant.write_text(text.replace(old, new, count))
    res = lint([str(mutant)], select=[rule_id], root=str(tmp_path))
    msgs = [f.message for f in res.findings if f.rule == rule_id]
    for w in want:
        assert any(w in m for m in msgs), (w, res.format_human())
    clean = lint([src], select=[rule_id], root=REPO)
    assert clean.findings == [], clean.format_human()


# ---------------------------------------------------------------------------
# the CLI and the repo-wide gate
# ---------------------------------------------------------------------------

def _cli(args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_cli_list_rules_bad_select_and_findings(tmp_path):
    proc = _cli(["--list-rules"])
    assert proc.returncode == 0
    assert [ln.split()[0] for ln in proc.stdout.splitlines()] == [
        f"RL00{i}" for i in range(1, 9)]
    assert _cli(["--select", "RL999", "src"]).returncode == 2
    for name in ("rl001_bad.py", "rl004_bad.cu", "rl004_bounds.cuh"):
        shutil.copy(os.path.join(FIXTURES, name), tmp_path / name)
    proc = _cli(["--json", "--root", str(tmp_path), str(tmp_path)])
    assert proc.returncode == 1, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    found = [port.Finding.from_dict(d) for d in report["findings"]]
    assert {f.rule for f in found} == {"RL001", "RL004"}
    assert report["files_by_kind"] == {"py": 1, "cuda": 2}


def test_real_tree_is_clean():
    """The port, its tests and chip_smoke.py lint clean by default, the
    CUDA sources included; every suppression carries its reason."""
    proc = _cli(["--json"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(proc.stdout)
    assert report["findings"] == []
    assert report["files_by_kind"]["cuda"] >= 9
    assert report["files_by_kind"]["py"] > 100
    assert len(report["suppressed"]) >= 4
    for d in report["suppressed"]:
        line = open(os.path.join(REPO, d["path"]),
                    encoding="utf-8").read().splitlines()[d["line"] - 2]
        assert re.search(r"repro-lint: disable=RL\d+ -- \S", line), line


# ---------------------------------------------------------------------------
# RL007's repair: every raw wrapper refuses an input that requires grad
# ---------------------------------------------------------------------------

def _wrapper_cases():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gat_fused as gf
    from repro_torch.kernels import segment_sum as ss
    from repro_torch.kernels import ssd_chunk as sc
    rng = np.random.default_rng(3)

    def f(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32))

    i32 = lambda *v: torch.tensor(v, dtype=torch.int32)  # noqa: E731
    src, order, row_ptr = i32(0, 1, 2), i32(0, 1, 2), i32(0, 2, 3)
    h, coef, g2 = f(3, 4), f(3), f(2, 4)
    q = f(1, 2, 8, 64).to(torch.bfloat16)
    x, dt, A, Bm = f(1, 16, 2, 8), f(1, 16, 2).abs(), -f(2).abs(), \
        f(1, 16, 1, 8)
    return {
        "K1": (ss, ss.gather_scale_segment_sum_cuda,
               (h, src, coef, order, row_ptr, 2), "GatherScaleSegmentSum"),
        "K2": (ss, ss.segment_sum_cuda, (h, order, row_ptr, 2),
               "SegmentSum"),
        "K3": (gf, gf.gat_attention_cuda,
               (h, f(3, 2), f(2, 2), src, order, row_ptr, 2),
               "GatAttention"),
        "K3 VJP": (gf, gf.gat_backward_dst_cuda,
                   (g2, h, f(3, 2), f(2, 2), f(2, 2), f(2, 2), src, order,
                    row_ptr, 3), "no double backward"),
        "K4": (ss, ss.gather_scale_segment_sum_q_cuda,
               (torch.zeros(3, 4, dtype=torch.uint8), f(3, 1), f(3, 1), src,
                coef, order, row_ptr, 2), "forward only"),
        "K5": (ss, ss.gather_rows_cuda, (g2, src, order, 3), "GatherRows"),
        "K6": (ss, ss.edge_dot_cuda, (h, g2, src, order, row_ptr),
               "forward only"),
        "K7": (fa, fa.flash_attention_cuda, (q, q, q), "FlashAttention"),
        "K7 VJP": (fa, fa.flash_attention_bwd_cuda,
                   (q, q, q, q, q, f(1, 2, 8)), "no double backward"),
        "K8": (sc, sc.ssd_chunk_state_cuda, (x, dt, A, Bm), "SSDChunkState"),
        "K8 VJP": (sc, sc.ssd_chunk_state_bwd_cuda,
                   (x, dt, A, Bm, f(1, 2, 8, 8)), "no double backward"),
    }


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K3 VJP", "K4", "K5",
                                    "K6", "K7", "K7 VJP", "K8", "K8 VJP"])
def test_raw_wrapper_refuses_an_input_that_requires_grad(kernel,
                                                         monkeypatch):
    """With the device check stood in for (no card here), a raw wrapper
    given a floating input that requires grad, grad enabled, raises
    NotImplementedError naming its Function (or saying nothing
    differentiates it) before anything is built; under no_grad it goes
    on past the refusal (here to the stubbed build)."""
    from repro_torch.kernels import build
    module, fn, args, names = _wrapper_cases()[kernel]
    monkeypatch.setattr(module, "_require_cuda", lambda t, what: t.device)

    class Built(Exception):
        pass

    def no_build(name):
        raise Built(name)
    monkeypatch.setattr(build, "library", no_build)
    floating = [i for i, a in enumerate(args)
                if torch.is_tensor(a) and a.is_floating_point()]
    grad_args = list(args)
    i = floating[-1]
    grad_args[i] = args[i].clone().requires_grad_()
    with pytest.raises(NotImplementedError, match=names):
        fn(*grad_args)
    with torch.no_grad():
        with pytest.raises(Exception) as e:
            fn(*grad_args)
    assert not isinstance(e.value, NotImplementedError)
