"""RL001 — a differentiable collective inside the loss (the port's
gradient-scaling class; the reference's RL001 looks for ``jax.lax.psum``
under ``jax.grad``).

The port's distributed steps compute each rank's LOCAL loss, call
``backward()``, and only then sum the gradients and the loss over the
ranks (``core/propagation.sum_grads_and_loss``).  A collective with a
backward inside that loss — ``AllGather.apply`` / ``ReduceScatter.apply``
(``core/collectives.py``) or ``torch.distributed.nn.functional.*`` — is
differentiated too: ``C.AllGather.apply(loss.reshape(1)).sum()`` makes
every rank's loss the global one, its backward reduce-scatters ``world``
cotangents of 1 onto each rank, and the summed gradients come out scaled
by the world size.  Adam's scale invariance hides it from loss curves.

What is "inside the loss": the expression given to ``<t>.backward()``,
``torch.autograd.backward(<t>)`` or ``torch.autograd.grad(<t>, ...)``,
and, through the names it reads, every assignment to those names earlier
in the same function (a backward slice within the function; ``.detach()``
and ``.item()`` stop it), with every same-module function those
expressions call
(:meth:`~repro_torch.analysis.astutil.FunctionIndex.reachable_calls`).
Forward-pass sharding primitives (the pull all-gather, the push and P3
reduce-scatters, whose transposes are exact) are reached this way and
carry justified suppressions at the call site, as the reference's
``psum_scatter`` sites do.  What the module cannot see (a loss function
passed in as an argument, a method, another module's forward) is
skipped, never guessed.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import Finding, ModuleContext, Rule

#: autograd Functions of ``core/collectives.py`` whose ``apply`` is a
#: collective with a backward
COLLECTIVE_FUNCTIONS = {"AllGather", "ReduceScatter"}
DIST_NN_MODULE = "torch.distributed.nn.functional"
GRAD_QUALNAMES = {"torch.autograd.grad", "autograd.grad"}
BACKWARD_QUALNAMES = {"torch.autograd.backward", "autograd.backward"}
#: method calls whose result carries no graph: the slice stops there
GRAPH_CUTS = {"detach", "item", "tolist"}


def _dist_nn_aliases(tree: ast.AST):
    """Local names of ``torch.distributed.nn.functional`` (modules) and of
    functions imported from it."""
    modules: Set[str] = set()
    names: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == DIST_NN_MODULE and a.asname:
                    modules.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                if node.module == "torch.distributed.nn" \
                        and a.name == "functional":
                    modules.add(a.asname or a.name)
                elif node.module == DIST_NN_MODULE:
                    names.add(a.asname or a.name)
    return modules, names


def _cut(node: ast.AST) -> bool:
    """A ``x.detach()`` / ``x.item()`` / ``x.tolist()`` call."""
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in GRAPH_CUTS)


def _walk_graph(node: ast.AST) -> Iterable[ast.AST]:
    """``ast.walk`` that does not enter graph cuts (:func:`_cut`, the
    root included) or nested function definitions."""
    stack = [] if _cut(node) else [node]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if not (isinstance(child, astutil.FunctionNode + (ast.Lambda,))
                    or _cut(child)):
                stack.append(child)


def _target_names(target: ast.AST) -> List[str]:
    return [n.id for n in ast.walk(target) if isinstance(n, ast.Name)]


def _assignments(fn: ast.AST, before: int) -> Dict[str, List[ast.AST]]:
    """name -> value expressions assigned to it in ``fn``'s own body (not
    nested defs) on lines before ``before``; a ``for`` target depends on
    its iterable."""
    out: Dict[str, List[ast.AST]] = {}
    for node in _walk_graph(fn):
        if getattr(node, "lineno", before) >= before:
            continue
        pairs = []
        if isinstance(node, ast.Assign):
            pairs = [(t, node.value) for t in node.targets]
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) \
                and node.value is not None:
            pairs = [(node.target, node.value)]
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            pairs = [(node.target, node.iter)]
        for target, value in pairs:
            for name in _target_names(target):
                out.setdefault(name, []).append(value)
    return out


def _loss_slice(fn: ast.AST, loss: ast.AST, line: int) -> List[ast.AST]:
    """The expressions the loss at ``line`` is computed from, within
    ``fn``: ``loss`` itself and every earlier assignment to a name it
    reads, transitively."""
    assigns = _assignments(fn, line)
    exprs, seen = [loss], set()
    i = 0
    while i < len(exprs):
        for n in _walk_graph(exprs[i]):
            if isinstance(n, ast.Name) and n.id not in seen:
                seen.add(n.id)
                exprs.extend(assigns.get(n.id, ()))
        i += 1
    return exprs


def _loss_of(call: ast.Call) -> Optional[ast.AST]:
    """The tensor a backward call differentiates, or None."""
    qn = astutil.call_name(call)
    if qn in GRAD_QUALNAMES or qn in BACKWARD_QUALNAMES:
        if call.args:
            return call.args[0]
        for kw in call.keywords:
            if kw.arg in ("outputs", "tensors"):
                return kw.value
        return None
    if isinstance(call.func, ast.Attribute) and call.func.attr == "backward":
        return call.func.value
    return None


class CollectiveInLossRule(Rule):
    """Flag a collective with a backward (``AllGather.apply``,
    ``ReduceScatter.apply``, ``torch.distributed.nn.functional.*``)
    reachable, within the module, from the loss given to a backward."""

    rule_id = "RL001"
    name = "collective-in-loss"

    def check_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        tree = ctx.tree
        index = astutil.FunctionIndex(tree)
        nn_modules, nn_names = _dist_nn_aliases(tree)

        def is_collective(call: ast.Call) -> bool:
            qn = astutil.call_name(call)
            if qn is None:
                return False
            parts = qn.split(".")
            if (len(parts) >= 2 and parts[-1] == "apply"
                    and parts[-2] in COLLECTIVE_FUNCTIONS):
                return True
            return (qn.startswith(DIST_NN_MODULE + ".")
                    or qn in nn_names
                    or (len(parts) == 2 and parts[0] in nn_modules))

        findings: List[Finding] = []
        reported = set()
        scopes = [tree] + [n for n in ast.walk(tree)
                           if isinstance(n, astutil.FunctionNode)]
        for fn in scopes:
            for node in _walk_graph(fn):
                if node is fn or not isinstance(node, ast.Call):
                    continue
                loss = _loss_of(node)
                if loss is None:
                    continue
                for expr in _loss_slice(fn, loss, node.lineno):
                    for call, via in _reached(
                            expr, getattr(fn, "name", "<module>"), index,
                            is_collective):
                        key = (call.lineno, call.col_offset)
                        if key in reported:
                            continue
                        reported.add(key)
                        findings.append(Finding(
                            self.rule_id, ctx.path, call.lineno,
                            f"`{astutil.call_name(call)}` is reachable "
                            f"(via `{via}`) from the loss differentiated "
                            f"at line {node.lineno}: it is "
                            f"differentiated with the loss, and the "
                            f"ranks' gradients are summed again after the "
                            f"backward, scaling them by the world size — "
                            f"move the collective "
                            f"after the backward, or suppress with "
                            f"justification if it is a forward-pass "
                            f"sharding primitive whose transpose is "
                            f"exact"))
        return findings


def _reached(expr: ast.AST, label: str, index: astutil.FunctionIndex,
             is_collective) -> List:
    """``(call, via)`` for the collective calls in ``expr`` itself (via
    ``label``, the function it is in) and in the same-module functions it
    calls."""
    hits = []
    for n in _walk_graph(expr):
        if not isinstance(n, ast.Call):
            continue
        if is_collective(n):
            hits.append((n, label))
        if isinstance(n.func, ast.Name):
            for callee in index.resolve(n.func.id):
                hits.extend(index.reachable_calls(callee, is_collective))
    return hits
