"""RL002 — device or environment resolution inside a compiled or captured
region (the port's counterpart of the reference's trace-pinned dispatch
rule, which looks for backend reads under ``jax.jit``).

A region's Python runs once and its result is replayed:

* a function ``torch.compile`` compiles is traced by dynamo, and what it
  read from ``os.environ`` or the CUDA runtime is baked into the graph it
  caches;
* the body of ``with torch.cuda.graph(g):`` and a callable given to
  ``torch.cuda.make_graphed_callables`` run once, during capture; every
  replay repeats the kernels captured then, whatever the process's state
  is now.

So ``torch.cuda.is_available()`` / ``device_count()`` /
``current_device()``, ``os.environ`` / ``os.getenv`` and the
``allow_tf32`` flags, read inside a region (lexically, or in a
same-module function it calls), pin the device or precision decision of
the first trace or capture.  Resolve them in plain code outside the
region (``repro_torch.device.resolve``) and pass the result in.
Regions the module cannot see (a method compiled elsewhere) are skipped.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Tuple

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import Finding, ModuleContext, Rule

COMPILE_QUALNAMES = {"torch.compile"}
GRAPH_QUALNAMES = {"torch.cuda.graph", "cuda.graph"}
GRAPHED_QUALNAMES = {"torch.cuda.make_graphed_callables",
                     "cuda.make_graphed_callables"}
PARTIAL_QUALNAMES = {"functools.partial", "partial"}
ENV_CALL_QUALNAMES = {
    "torch.cuda.is_available", "torch.cuda.device_count",
    "torch.cuda.current_device", "cuda.is_available", "cuda.device_count",
    "cuda.current_device", "os.getenv",
}
FLAG_ATTRS = {"allow_tf32"}


def _env_access(node: ast.AST) -> bool:
    """``os.environ[...]`` / ``os.environ.get`` and ``...allow_tf32``."""
    if isinstance(node, (ast.Subscript, ast.Attribute)) and \
            astutil.qualname(getattr(node, "value", None)) == "os.environ":
        return True
    return isinstance(node, ast.Attribute) and node.attr in FLAG_ATTRS


class CompiledRegionDispatchRule(Rule):
    """Flag device/environment reads lexically or transitively (within
    the module) inside ``torch.compile``d functions, ``torch.cuda.graph``
    capture bodies and callables given to
    ``torch.cuda.make_graphed_callables``."""

    rule_id = "RL002"
    name = "compiled-region-dispatch"

    def check_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        tree = ctx.tree
        if not any(s in ctx.source for s in ("compile", "graph")):
            return []
        index = astutil.FunctionIndex(tree)
        compile_names = COMPILE_QUALNAMES | astutil.imported_aliases(
            tree, ("torch",), {"compile"})

        def is_compile(node: ast.AST) -> bool:
            qn = astutil.qualname(node)
            if qn in compile_names:
                return True
            if isinstance(node, ast.Call):
                fn = astutil.call_name(node)
                if fn in compile_names:
                    return True
                if fn in PARTIAL_QUALNAMES and node.args:
                    return astutil.qualname(node.args[0]) in compile_names
            return False

        regions: List[Tuple[str, ast.AST]] = []
        for node in ast.walk(tree):
            if isinstance(node, astutil.FunctionNode):
                if any(is_compile(d) for d in node.decorator_list):
                    regions.append((f"torch.compile'd `{node.name}`",
                                    node))
            elif isinstance(node, ast.Call) and node.args:
                qn = astutil.call_name(node)
                kind = ("torch.compile'd" if qn in compile_names
                        else "graphed callable" if qn in GRAPHED_QUALNAMES
                        else None)
                if kind:
                    regions += [(f"{kind} `{_name(f)}`", f)
                                for f in _callables(node.args[0], index)]
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                if any(isinstance(it.context_expr, ast.Call)
                       and astutil.call_name(it.context_expr)
                       in GRAPH_QUALNAMES for it in node.items):
                    regions += [(f"the torch.cuda.graph capture at line "
                                 f"{node.lineno}", stmt)
                                for stmt in node.body]

        def is_env_read(call: ast.Call) -> bool:
            if astutil.call_name(call) in ENV_CALL_QUALNAMES:
                return True
            return any(_env_access(sub) for sub in ast.walk(call.func))

        findings: List[Finding] = []
        reported = set()

        def add(node: ast.AST, what: str, region: str, via: str) -> None:
            key = (node.lineno, node.col_offset)
            if key in reported:
                return
            reported.add(key)
            findings.append(Finding(
                self.rule_id, ctx.path, node.lineno,
                f"`{what}` read inside {region} (via `{via}`): it runs "
                f"once, at the first trace or capture, and every later "
                f"call or replay keeps that decision — resolve it outside "
                f"the region (repro_torch.device.resolve) and pass the "
                f"result in"))

        for region, body in regions:
            for sub in ast.walk(body):
                if _env_access(sub):
                    add(sub, astutil.qualname(sub) or "os.environ", region,
                        _name(body))
            for call, via in index.reachable_calls(body, is_env_read):
                add(call, astutil.call_name(call) or "os.environ", region,
                    via)
        return findings


def _name(fn: ast.AST) -> str:
    return getattr(fn, "name", "<lambda>" if isinstance(fn, ast.Lambda)
                   else "<body>")


def _callables(arg: ast.AST, index: astutil.FunctionIndex) -> List[ast.AST]:
    """Function bodies an argument can denote: a lambda, a same-module
    def, a tuple of those, or ``functools.partial`` of one."""
    if isinstance(arg, ast.Lambda):
        return [arg]
    if isinstance(arg, ast.Name):
        return index.resolve(arg.id)
    if isinstance(arg, (ast.Tuple, ast.List)):
        return [f for e in arg.elts for f in _callables(e, index)]
    if isinstance(arg, ast.Call) and \
            astutil.call_name(arg) in PARTIAL_QUALNAMES and arg.args:
        return _callables(arg.args[0], index)
    return []
