"""RL006 — ``Transport`` constructed without an explicit ``path=`` label.

The reference's rule of the same id, copied.  Every
:class:`repro_torch.core.comm.Transport` mirrors its byte accounting into
``comm_bytes_total{path,codec,kind}``; the ``path`` label is the
series key.  A construction that omits ``path=`` silently lands on
``path="default"`` and MERGES with every other unlabeled transport — the
per-path byte attribution the benchmarks and docs promise quietly becomes
wrong, with no error anywhere.  This rule makes the label mandatory at
every construction site, tests included (test transports that merge into
``default`` pollute cross-test telemetry assertions).
"""
from __future__ import annotations

import ast
from typing import Iterable, List

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import Finding, ModuleContext, Rule


class TransportPathRule(Rule):
    """Flag ``Transport(...)`` calls lacking a ``path=`` keyword."""

    rule_id = "RL006"
    name = "transport-path-label"

    def check_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        findings: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            qn = astutil.call_name(node)
            if qn is None or not (qn == "Transport"
                                  or qn.endswith(".Transport")):
                continue
            if any(kw.arg == "path" for kw in node.keywords):
                continue
            if any(kw.arg is None for kw in node.keywords):
                continue                       # **kwargs may carry path
            findings.append(Finding(
                self.rule_id, ctx.path, node.lineno,
                "Transport constructed without an explicit `path=` "
                "label: its bytes merge into "
                'comm_bytes_total{path="default"} with every other '
                "unlabeled transport, silently corrupting per-path "
                "byte attribution — name the transfer path"))
        return findings
