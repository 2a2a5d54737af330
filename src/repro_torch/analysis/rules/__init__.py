"""Rule registry for ``repro_torch.analysis``.

Each rule encodes one bug class of the PyTorch/CUDA port, under the id of
the reference rule it answers where there is one — see the catalog in
:mod:`repro_torch.analysis`.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

from repro_torch.analysis.engine import Rule
from repro_torch.analysis.rules.collective_loss import CollectiveInLossRule
from repro_torch.analysis.rules.compiled_region import (
    CompiledRegionDispatchRule)
from repro_torch.analysis.rules.cuda_launch import CudaLaunchRule
from repro_torch.analysis.rules.float_clock import FloatClockProgressRule
from repro_torch.analysis.rules.hidden_fallback import HiddenFallbackRule
from repro_torch.analysis.rules.raw_wrapper_grad import RawWrapperGradRule
from repro_torch.analysis.rules.telemetry_drift import TelemetryCatalogRule
from repro_torch.analysis.rules.transport_path import TransportPathRule

__all__ = [
    "CollectiveInLossRule", "CompiledRegionDispatchRule",
    "FloatClockProgressRule", "CudaLaunchRule", "TelemetryCatalogRule",
    "TransportPathRule", "RawWrapperGradRule", "HiddenFallbackRule",
    "build_rules", "RULE_CLASSES",
]

#: Rule id -> class, for ``--select`` and ``--list-rules``.
RULE_CLASSES = {cls.rule_id: cls for cls in (
    CollectiveInLossRule, CompiledRegionDispatchRule, FloatClockProgressRule,
    CudaLaunchRule, TelemetryCatalogRule, TransportPathRule,
    RawWrapperGradRule, HiddenFallbackRule)}


def build_rules(root: str,
                select: Optional[Sequence[str]] = None) -> List[Rule]:
    """Instantiate the default rule set (fresh instances — RL005 carries
    per-run state).  ``root`` anchors the docs-catalog path; ``select``
    restricts to the given rule ids."""
    rules: List[Rule] = [
        cls(doc_path=os.path.join(root, "docs", "observability.md"))
        if cls is TelemetryCatalogRule else cls()
        for _, cls in sorted(RULE_CLASSES.items())]
    if select:
        wanted = set(select)
        rules = [r for r in rules if r.rule_id in wanted]
    return rules
