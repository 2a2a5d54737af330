"""RL005 — telemetry catalog drift between source and
``docs/observability.md`` (the reference's rule of the same id, copied,
less the catalog rows the port has no counterpart for).

The metric catalog in ``docs/observability.md`` is the contract dashboards
and scrape configs are written against.  Nothing used to stop a new
``telemetry.counter("shiny_new_total", ...)`` from shipping without a
catalog row — or a catalog row from outliving the code that recorded it.
This rule closes the loop in both directions, and reads the catalog
without ever editing it:

* every metric NAME string literal registered in ``src/`` (via
  ``telemetry.counter/gauge/histogram`` or the direct
  ``Counter/Gauge/Histogram`` constructors) must appear in the catalog
  table;
* every name in the catalog table must be registered somewhere in
  ``src/``, except the rows of :data:`NO_COUNTERPART`;
* a name of :data:`NO_COUNTERPART` that IS registered is a finding too
  (the exception outlived its reason).

Dynamically-built names (non-literal first argument) are skipped — the
repo has none, and keeping it that way is itself the discipline.
"""
from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import Finding, ModuleContext, Rule

FACTORY_ATTRS = {"counter", "gauge", "histogram",
                 "Counter", "Gauge", "Histogram"}
NAME_RE = re.compile(r"`([a-z][a-z0-9_]*)`")
CATALOG_HEADING = "## Metric catalog"

#: Catalog rows the port registers nowhere, each with its reason: they
#: are the metrics of the reference's TPU capacity dispatch (its VMEM
#: check choosing a fused, blocked, unfused or multi-pass kernel), which
#: has no counterpart on the card (``repro_torch.kernels.ops``: one
#: kernel per operation, whose working set does not grow with the graph)
NO_COUNTERPART = {
    "kernel_dispatch_total":
        "counts the capacity dispatch's choice of implementation; the "
        "port has one kernel per operation and counts its launches "
        "(ops.launch_counts)",
    "kernel_hbm_model_bytes":
        "the modelled HBM bytes of the dispatched TPU implementation; "
        "the port's bounds are computed by chip_smoke.py",
    "kernel_tile_density":
        "the locality of the TPU's blocked one-hot tiles; the port's "
        "kernels walk grouped layouts, with no tiles to fill",
}


class TelemetryCatalogRule(Rule):
    """Two-way diff between registered metric names in ``src/`` and the
    ``docs/observability.md`` catalog table."""

    rule_id = "RL005"
    name = "telemetry-catalog-drift"

    def __init__(self, doc_path: str, src_prefix: str = "src/"):
        self.doc_path = doc_path
        self.src_prefix = src_prefix
        #: name -> first (path, line) that registered it
        self._registered: Dict[str, Tuple[str, int]] = {}
        #: did this run visit ANY module under src_prefix?  Doc-side
        #: stale-row findings are only meaningful when it did — a run
        #: scoped to a single file elsewhere must not declare the whole
        #: catalog stale.
        self._saw_src = False

    def check_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        if not ctx.relpath.startswith(self.src_prefix):
            return []
        self._saw_src = True
        direct_ctors = astutil.imported_aliases(
            ctx.tree, ("telemetry",), {"Counter", "Gauge", "Histogram"})
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            qn = astutil.call_name(node)
            if qn is None:
                continue
            head, _, tail = qn.rpartition(".")
            is_factory = (tail in FACTORY_ATTRS
                          and head.split(".")[-1] in ("telemetry",
                                                      "registry"))
            is_ctor = qn in direct_ctors
            if not (is_factory or is_ctor):
                continue
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(first.value,
                                                              str):
                self._registered.setdefault(
                    first.value, (ctx.path, node.lineno))
        return []

    def finalize(self) -> Iterable[Finding]:
        catalog = _parse_catalog(self.doc_path)
        if catalog is None:
            if self._registered:
                path, line = next(iter(self._registered.values()))
                return [Finding(
                    self.rule_id, path, line,
                    f"metrics are registered in source but the catalog "
                    f"file `{self.doc_path}` is missing or has no "
                    f"`{CATALOG_HEADING}` table")]
            return []
        findings: List[Finding] = []
        doc_names = {name for name, _ in catalog}
        for name, (path, line) in sorted(self._registered.items()):
            if name in NO_COUNTERPART:
                findings.append(Finding(
                    self.rule_id, path, line,
                    f"metric `{name}` is listed in NO_COUNTERPART "
                    f"(rules/telemetry_drift.py) as having no counterpart "
                    f"in the port, but is registered here — drop it from "
                    f"that list"))
            elif name not in doc_names:
                findings.append(Finding(
                    self.rule_id, path, line,
                    f"metric `{name}` is recorded in source but missing "
                    f"from the {os.path.basename(self.doc_path)} "
                    f"catalog — add a catalog row (name, kind, labels, "
                    f"recorded-by)"))
        for name, line in catalog:
            if name in NO_COUNTERPART:
                continue
            if self._saw_src and name not in self._registered:
                findings.append(Finding(
                    self.rule_id, self.doc_path, line,
                    f"metric `{name}` is in the catalog but registered "
                    f"nowhere under `{self.src_prefix}` — delete the "
                    f"stale row or restore the instrumentation"))
        return findings


def _parse_catalog(doc_path: str) -> Optional[List[Tuple[str, int]]]:
    """Metric names from the catalog table: backticked identifiers in the
    FIRST cell of each row under ``## Metric catalog`` (a cell may hold
    several, e.g. ```a` / `b```).  Returns ``None`` if the file or
    section is absent."""
    try:
        with open(doc_path, encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    out: List[Tuple[str, int]] = []
    in_section = False
    for i, line in enumerate(lines, start=1):
        if line.startswith("## "):
            in_section = line.strip() == CATALOG_HEADING
            continue
        if not in_section or not line.lstrip().startswith("|"):
            continue
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if not cells or set(cells[0]) <= {"-", " ", ":"}:
            continue                                   # separator row
        if cells[0].lower() == "metric":
            continue                                   # header row
        for name in NAME_RE.findall(cells[0]):
            out.append((name, i))
    return out if out else None
