"""RL003 — inline virtual-clock advance without the one-ulp progress
guard (the float-clock livelock class; the reference's rule of the same
id, copied).

The serve loops once advanced their virtual clock with
``vnow = max(vnow, nxt)``.  When the event jump lands *exactly* on
``fl(oldest + max_wait)``, the recomputed head-of-line wait
``vnow - oldest`` can round one error short of ``max_wait_s`` — the
batcher keeps refusing to emit and ``max()`` pins the clock forever at
100% CPU.  The fix is a strict one-ulp ``math.nextafter`` march, kept in
one helper, :func:`repro_torch.serving.request.advance_vclock`, and this
rule enforces the helper: ANY inline re-derivation of clock progress
(``max()`` or a ternary that can return the clock unchanged, and
hand-rolled ``nextafter`` ternaries that duplicate the helper) is
flagged.
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import Finding, ModuleContext, Rule

#: Variables treated as virtual clocks.  Scoped tightly on purpose: the
#: rule must never fire on ordinary ``x = max(x, y)`` accumulators.
CLOCK_NAMES = {"vnow", "v_now", "vclock", "v_clock", "vtime", "v_time",
               "virtual_now"}

#: The one function allowed to spell the advance inline.
HELPER_NAME = "advance_vclock"


def _mentions(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               for n in ast.walk(node))


def _has_max_call(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Call) and astutil.call_name(n) == "max"
               for n in ast.walk(node))


class FloatClockProgressRule(Rule):
    """Flag ``clock = max(clock, ...)`` / ``clock = ... if ... else
    <expr involving clock>`` self-advances outside the shared helper."""

    rule_id = "RL003"
    name = "float-clock-progress"

    def check_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        enclosing = astutil.enclosing_functions(ctx.tree)
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target = node.targets[0]
            if not (isinstance(target, ast.Name)
                    and target.id in CLOCK_NAMES):
                continue
            if enclosing.get(id(node)) == HELPER_NAME:
                continue                       # the helper's own body
            value = node.value
            if not _mentions(value, target.id):
                continue                       # fresh value, not a step
            inline_advance = (isinstance(value, ast.IfExp)
                              or _has_max_call(value))
            if inline_advance:
                findings.append(Finding(
                    self.rule_id, ctx.path, node.lineno,
                    f"inline virtual-clock advance of `{target.id}`: "
                    f"`max()`/ternary steps can land exactly on the "
                    f"head-of-line deadline and pin the clock one ulp "
                    f"short forever (float-clock livelock class) — use "
                    f"`repro_torch.serving.request.advance_vclock"
                    f"({target.id}, nxt)`"))
        return findings
