"""Shared AST helpers for the lint rules.

Everything here is *within-module* analysis on stdlib ``ast`` trees: the
linter deliberately never imports the code it checks (fixture corpora
containing live bugs must stay inert) and never chases imports across
files — a rule that needs cross-module facts (RL005's docs catalog)
reads the other artifact directly.
"""
from __future__ import annotations

import ast
from typing import Callable, Dict, List, Optional, Set, Tuple


def qualname(node: ast.AST) -> Optional[str]:
    """Dotted name of a ``Name``/``Attribute`` chain (``jax.lax.psum``),
    or ``None`` for anything not a plain dotted reference."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> Optional[str]:
    """Dotted name of a call's callee (see :func:`qualname`)."""
    return qualname(call.func)


def imported_aliases(tree: ast.AST, module_suffixes: Tuple[str, ...],
                     names: Set[str]) -> Set[str]:
    """Local aliases bound by ``from <m> import n [as a]`` where ``m``
    ends with one of ``module_suffixes`` and ``n`` is in ``names``."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            if any(node.module == s or node.module.endswith("." + s)
                   for s in module_suffixes):
                for alias in node.names:
                    if alias.name in names:
                        out.add(alias.asname or alias.name)
    return out


def const_int(node: ast.AST,
              env: Dict[str, int]) -> Optional[int]:
    """Fold ``node`` to an int using literals, ``env`` names, and the
    arithmetic the kernel modules actually use (``8 * 2**20``).  Returns
    ``None`` when any leaf is unresolvable — rules skip, never guess."""
    if isinstance(node, ast.Constant):
        return node.value if isinstance(node.value, int) else None
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = const_int(node.operand, env)
        return -v if v is not None else None
    if isinstance(node, ast.BinOp):
        lhs = const_int(node.left, env)
        rhs = const_int(node.right, env)
        if lhs is None or rhs is None:
            return None
        if isinstance(node.op, ast.Add):
            return lhs + rhs
        if isinstance(node.op, ast.Sub):
            return lhs - rhs
        if isinstance(node.op, ast.Mult):
            return lhs * rhs
        if isinstance(node.op, ast.FloorDiv) and rhs != 0:
            return lhs // rhs
        if isinstance(node.op, ast.Mod) and rhs != 0:
            return lhs % rhs
        if isinstance(node.op, ast.Pow) and rhs >= 0:
            return lhs ** rhs
    return None


def module_int_constants(tree: ast.AST) -> Dict[str, int]:
    """Top-level ``NAME = <int expr>`` bindings, folded (two passes so
    constants may reference earlier constants)."""
    env: Dict[str, int] = {}
    for _ in range(2):
        for node in getattr(tree, "body", []):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)):
                v = const_int(node.value, env)
                if v is not None:
                    env[node.targets[0].id] = v
    return env


def assigned_names(fn: ast.AST) -> Set[str]:
    """Names (re)bound by assignment statements inside ``fn`` — used to
    invalidate parameter-default resolution (``bq = min(bq, Sq)`` means
    ``bq`` is no longer its declared default)."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            for leaf in ast.walk(t):
                if isinstance(leaf, ast.Name):
                    out.add(leaf.id)
    return out


FunctionNode = (ast.FunctionDef, ast.AsyncFunctionDef)


class FunctionIndex:
    """Within-module call-graph closure.

    Maps simple function names to their (possibly several) defs and
    answers "starting from this function, which calls matching
    ``predicate`` are reachable?" by following calls to *simple names*
    defined in the same module.  Lexically nested code (inner defs,
    lambdas, comprehensions) counts as reachable from its enclosing
    function — a sound over-approximation for the bug classes here.
    """

    def __init__(self, tree: ast.AST):
        self.defs: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(tree):
            if isinstance(node, FunctionNode):
                self.defs.setdefault(node.name, []).append(node)

    def resolve(self, name: str) -> List[ast.AST]:
        """All same-module defs bound to ``name`` (empty if imported or
        dynamically constructed)."""
        return self.defs.get(name, [])

    def reachable_calls(
            self, entry: ast.AST,
            predicate: Callable[[ast.Call], bool],
    ) -> List[Tuple[ast.Call, str]]:
        """DFS from ``entry``: matching calls found lexically inside the
        entry or inside any same-module function it (transitively)
        calls.  Returns ``(call, via)`` where ``via`` is the name of the
        function whose body contains the call."""
        hits: List[Tuple[ast.Call, str]] = []
        seen_fns: Set[int] = set()
        seen_calls: Set[Tuple[int, int]] = set()
        stack: List[Tuple[ast.AST, str]] = [
            (entry, getattr(entry, "name", "<lambda>"))]
        while stack:
            fn, label = stack.pop()
            if id(fn) in seen_fns:
                continue
            seen_fns.add(id(fn))
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                if predicate(node):
                    key = (node.lineno, node.col_offset)
                    if key not in seen_calls:
                        seen_calls.add(key)
                        hits.append((node, label))
                if isinstance(node.func, ast.Name):
                    for callee in self.resolve(node.func.id):
                        stack.append((callee, node.func.id))
        return hits


def enclosing_functions(tree: ast.AST) -> Dict[int, str]:
    """Map ``id(node)`` -> name of the nearest enclosing function for
    every node in ``tree`` (nodes at module level are absent)."""
    out: Dict[int, str] = {}

    def visit(node: ast.AST, current: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            name = current
            if isinstance(child, FunctionNode):
                name = child.name
            if current is not None:
                out[id(child)] = current
            visit(child, name)

    visit(tree, None)
    return out
