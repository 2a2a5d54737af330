"""RL007 — a raw kernel wrapper that can return an output with no
autograd graph (no counterpart in the reference: JAX differentiates
through a Pallas call's custom VJP or refuses).

A wrapper in ``kernels/*.py`` hands ``data_ptr()``\\ s to a C entry point
of ``build.library(...)`` and returns a tensor it allocated: autograd
records nothing.  Its plain version on the CPU is differentiable, so the
same call that trains on the CPU silently drops the gradient on the card
— the port shipped that once, with K7 and K8's raw forwards inside the
models.  The fixed idiom is ``segment_sum._refuse_grad(what, function,
*inputs)``: with grad enabled and a floating input that requires grad it
raises ``NotImplementedError`` naming the autograd Function that runs
the kernel with a backward (or saying the kernel is forward only).

Flagged: a public function (no leading underscore) at the top level of a
module under a ``kernels`` directory that reaches a ``build.library``
call — lexically or through same-module functions such as
``flash_attention._bwd_launch`` — before any ``_refuse_grad`` call.  The
function is read in source order with the helpers it calls inlined where
they are called; only a ``_refuse_grad`` that is a statement of its own
(not under an ``if``, a loop or a ``try``) counts, since a conditional
refusal still lets the launch through on the other branch.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import Finding, ModuleContext, Rule

REFUSAL = "_refuse_grad"
LAUNCH_QUALNAMES = {"build.library"}


class RawWrapperGradRule(Rule):
    """Flag public kernel wrappers that launch before refusing an input
    that requires grad."""

    rule_id = "RL007"
    name = "raw-wrapper-grad"

    def check_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        if "kernels" not in ctx.relpath.split("/")[:-1]:
            return []
        tree = ctx.tree
        index = astutil.FunctionIndex(tree)
        launch_names = LAUNCH_QUALNAMES | astutil.imported_aliases(
            tree, ("build",), {"library"})
        findings: List[Finding] = []
        for fn in getattr(tree, "body", []):
            if not isinstance(fn, astutil.FunctionNode) or \
                    fn.name.startswith("_"):
                continue
            launch = _first_event(fn, index, launch_names, set())
            if launch is None or launch[0] != "launch":
                continue
            _, line, via = launch
            findings.append(Finding(
                self.rule_id, ctx.path, fn.lineno,
                f"`{fn.name}` reaches a kernel launch (`build.library` at "
                f"line {line}, in `{via}`) with no `{REFUSAL}` before it: "
                f"on the card an input that requires grad gets an output "
                f"with no autograd graph, where the plain version on the "
                f"CPU is differentiable — call `{REFUSAL}(what, function, "
                f"*inputs)` first, naming the autograd Function (or None "
                f"for a forward-only kernel)"))
        return findings


def _first_event(fn: ast.AST, index: astutil.FunctionIndex,
                 launch_names: Set[str], active: Set[int]
                 ) -> Optional[tuple]:
    """The first of ``("refuse", line, fn)`` / ``("launch", line, fn)``
    reached from ``fn`` in source order, same-module callees inlined at
    their call, or None.  ``active`` guards against recursion."""
    if id(fn) in active:
        return None
    active = active | {id(fn)}
    unconditional = {id(s.value) for s in fn.body
                     if isinstance(s, ast.Expr)
                     and isinstance(s.value, ast.Call)}
    calls = sorted((n for n in ast.walk(fn) if isinstance(n, ast.Call)),
                   key=lambda n: (n.lineno, n.col_offset))
    for call in calls:
        qn = astutil.call_name(call)
        if qn in launch_names:
            return ("launch", call.lineno, fn.name)
        if qn == REFUSAL and id(call) in unconditional:
            return ("refuse", call.lineno, fn.name)
        if isinstance(call.func, ast.Name):
            for callee in index.resolve(call.func.id):
                event = _first_event(callee, index, launch_names, active)
                if event is not None:
                    return event
    return None
