"""RL008 — a fallback that hides the device or the kernel (no counterpart
in the reference; the port's "nothing falls back" contract,
``kernels/ops.py`` and ``device.py``).

Every entry point of the port runs on the card unless the caller asks
for the CPU, and a kernel that fails to build or launch is an error: a
run that quietly took the CPU or a plain version reports the card's
numbers for work the card never did.  Two forms are flagged in program
files (not under ``tests/``, not ``chip_smoke.py``, which check on
purpose):

(a) ``torch.cuda.is_available()`` anywhere but ``device.resolve``, the
    one place that decides, and raises, when a card is asked for and
    there is none.  ``torch.cuda.device_count()``, which maps ranks to
    cards, is left alone;
(b) an ``except`` handler, in a function that calls a ``*_cuda`` kernel
    wrapper, ``build.build`` or ``build.library``, that calls a
    ``*_plain`` function or makes a CPU device (``torch.device("cpu")``,
    ``.cpu()``, ``.to("cpu")``, ``device="cpu"``).
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import Finding, ModuleContext, Rule

AVAILABLE_SUFFIX = "cuda.is_available"
BUILD_QUALNAMES = {"build.build", "build.library"}
#: the one function allowed to ask, and the module it lives in
RESOLVER = ("device.py", "resolve")


def _is_cpu(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str) \
        and node.value.split(":")[0] == "cpu"


def _cpu_device(call: ast.Call) -> bool:
    """``torch.device("cpu")``, ``x.cpu()``, ``x.to("cpu")`` or a
    ``device="cpu"`` keyword."""
    qn = astutil.call_name(call) or ""
    if qn.endswith("device") and call.args and _is_cpu(call.args[0]):
        return True
    if isinstance(call.func, ast.Attribute):
        if call.func.attr == "cpu":
            return True
        if call.func.attr == "to" and any(_is_cpu(a) for a in call.args):
            return True
    return any(kw.arg == "device" and _is_cpu(kw.value)
               for kw in call.keywords)


def _launches(call: ast.Call) -> bool:
    qn = astutil.call_name(call) or ""
    return qn in BUILD_QUALNAMES or qn.split(".")[-1].endswith("_cuda")


class HiddenFallbackRule(Rule):
    """Flag CUDA-availability probes outside ``device.resolve`` and
    exception handlers that fall back to a plain version or the CPU
    around a kernel call."""

    rule_id = "RL008"
    name = "hidden-fallback"

    def check_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        parts = ctx.relpath.split("/")
        if parts[0] == "tests" or parts[-1] == "chip_smoke.py":
            return []
        tree = ctx.tree
        enclosing = astutil.enclosing_functions(tree)
        probes = astutil.imported_aliases(tree, ("torch.cuda",),
                                          {"is_available"})
        findings: List[Finding] = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            qn = astutil.call_name(node) or ""
            if not (qn.endswith(AVAILABLE_SUFFIX) or qn in probes):
                continue
            if (parts[-1], enclosing.get(id(node))) == RESOLVER:
                continue
            findings.append(Finding(
                self.rule_id, ctx.path, node.lineno,
                f"`{qn}()` outside `device.resolve`: a probe that picks "
                f"another path when there is no card hides it — take the "
                f"device from the caller (repro_torch.device.resolve "
                f"raises when a card is asked for and there is none)"))
        seen = set()
        for fn in ast.walk(tree):
            if not isinstance(fn, astutil.FunctionNode) or not any(
                    isinstance(n, ast.Call) and _launches(n)
                    for n in ast.walk(fn)):
                continue
            for handler in ast.walk(fn):
                if not isinstance(handler, ast.ExceptHandler):
                    continue
                for call in ast.walk(handler):
                    if not isinstance(call, ast.Call):
                        continue
                    qn = astutil.call_name(call) or ""
                    if id(call) in seen or not (
                            qn.split(".")[-1].endswith("_plain")
                            or _cpu_device(call)):
                        continue
                    seen.add(id(call))
                    findings.append(Finding(
                        self.rule_id, ctx.path, call.lineno,
                        f"`{fn.name}` calls a kernel and its `except` "
                        f"handler (line {handler.lineno}) falls back to "
                        f"`{qn or 'a call'}` — a build or launch failure "
                        f"on the card is an error, never a quiet switch "
                        f"to the plain version or the CPU"))
        return findings
