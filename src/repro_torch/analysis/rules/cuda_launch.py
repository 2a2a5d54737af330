"""RL004 — CUDA launch hygiene in the port's ``.cu`` / ``.cuh`` sources
(the reference's RL004 checks Pallas ``BlockSpec`` / VMEM shapes; the
port's kernels are CUDA C++, and this is their launch-site counterpart).

A launch on the card fails, or is refused, in ways the Python wrapper
sees only through the status the C entry point returns (``build.check``
raises on it).  Flagged:

(a) a ``kernel<<<grid, block, smem, stream>>>`` whose ``smem`` is not a
    literal (or a file-level ``constexpr``) of at most 49 152 bytes, with
    no checked ``cudaFuncSetAttribute(<same kernel>,
    cudaFuncAttributeMaxDynamicSharedMemorySize, ...)`` before it in the
    same function: above 48 KiB the launch fails without that opt-in.
    "Same kernel" is the same text, template arguments included;
(b) a ``cudaFuncSetAttribute`` whose result is dropped: a bare
    statement, or a variable no ``if`` tests afterwards (the opt-in fails
    for a size over the card's limit, and the launch then fails for a
    reason nobody reads);
(c) a launch whose error nobody reads: neither its host function nor
    every caller of that function in the file names
    ``cudaGetLastError()`` (or ``cudaPeekAtLastError()``) after it;
(d) a block size, a literal or a ``constexpr`` of the file or of the
    headers it includes from its own directory, above the first argument
    of the kernel's ``__launch_bounds__``: the launch fails with too many
    resources requested.

What cannot be resolved — a template-dependent or computed block size, a
kernel whose ``__launch_bounds__`` is in no file read, a launch spelled
inside a macro — is skipped for (d), never guessed; (a) treats an
``smem`` it cannot resolve as large.  The source is read as text:
comments, string literals and preprocessor lines are blanked first
(keeping every line's number), and a function is a brace block that
follows a parameter list outside any other function.
"""
from __future__ import annotations

import ast
import bisect
import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import CudaContext, Finding, Rule

#: dynamic shared memory a block may use without the opt-in
SMEM_LIMIT = 48 * 1024
ERROR_READS = ("cudaGetLastError", "cudaPeekAtLastError")
SMEM_ATTRIBUTE = "cudaFuncAttributeMaxDynamicSharedMemorySize"

_CONSTEXPR_RE = re.compile(
    r"\bconstexpr\s+(?:(?:unsigned|signed|long|short|int|size_t|"
    r"std::size_t)\s+)+(\w+)\s*=\s*([^;]+);")
_INCLUDE_RE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)
_NAMESPACE_RE = re.compile(r"\bnamespace\s+(\w+)\s*\{")
_BOUNDS_RE = re.compile(r"__launch_bounds__\s*\(\s*([^,)]+)")
_INT_SUFFIX_RE = re.compile(r"\b(\d+)[uUlL]+\b")


def blank_noncode(src: str) -> str:
    """``src`` with comments, string and character literals and
    preprocessor lines (continuations included) replaced by spaces; every
    newline, and so every offset and line number, is kept."""
    out = list(src)
    i, n = 0, len(src)
    line_start = True

    def blank(a: int, b: int) -> None:
        for k in range(a, min(b, n)):
            if out[k] != "\n":
                out[k] = " "

    while i < n:
        c = src[i]
        if line_start and c == "#":
            j = i
            while j < n and not (src[j] == "\n" and src[j - 1] != "\\"):
                j += 1
            blank(i, j)
            i = j
            continue
        if c == "\n":
            line_start = True
            i += 1
            continue
        if not c.isspace():
            line_start = False
        if src.startswith("//", i):
            j = src.find("\n", i)
            j = n if j < 0 else j
            blank(i, j)
            i = j
        elif src.startswith("/*", i):
            j = src.find("*/", i + 2)
            j = n if j < 0 else j + 2
            blank(i, j)
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and src[j] != c:
                j += 2 if src[j] == "\\" else 1
            blank(i, j + 1)
            i = j + 1
        else:
            i += 1
    return "".join(out)


def _match(text: str, start: int, open_: str, close: str) -> int:
    """Index just past the bracket closing the one at ``start``."""
    depth = 0
    for k in range(start, len(text)):
        if text[k] == open_:
            depth += 1
        elif text[k] == close:
            depth -= 1
            if depth == 0:
                return k + 1
    return len(text)


def split_args(text: str) -> List[str]:
    """Top-level comma-separated arguments (brackets of any kind and
    template angle brackets nest)."""
    args, depth, cur = [], 0, []
    for c in text:
        if c in "([{<":
            depth += 1
        elif c in ")]}>":
            depth -= 1
        if c == "," and depth == 0:
            args.append("".join(cur).strip())
            cur = []
        else:
            cur.append(c)
    if "".join(cur).strip():
        args.append("".join(cur).strip())
    return args


def _ident_before(text: str, end: int, start: int = 0) -> int:
    """Start of the (``::``-qualified) identifier that ends at ``end`` in
    ``text``, skipping whitespace before ``end``; -1 if there is none."""
    j = end
    while j > start and text[j - 1].isspace():
        j -= 1
    k = j
    while k > start and (text[k - 1].isalnum() or text[k - 1] in "_:"):
        k -= 1
    return k if k < j and not text[k].isdigit() else -1


def _strip_qualifiers(head: str) -> str:
    """``head`` without trailing whitespace and ``const`` / ``noexcept``
    / ``override`` (what may stand between a parameter list and its
    body)."""
    tail = head.rstrip()
    while True:
        for word in ("const", "noexcept", "override"):
            if tail.endswith(word) and not (
                    tail[:-len(word)][-1:].isalnum()
                    or tail[:-len(word)][-1:] == "_"):
                tail = tail[:-len(word)].rstrip()
                break
        else:
            return tail


def _norm(text: str) -> str:
    return re.sub(r"\s+", "", text)


@dataclasses.dataclass
class Function:
    """A host or device function: its name, header text, body span
    ``[start, end)`` in the blanked text, and whether it is a kernel."""
    name: str
    header: str
    start: int
    end: int
    kernel: bool


def functions(code: str) -> List[Function]:
    """Every function of the blanked text: a ``{`` that follows a
    parameter list ``)`` (optionally ``const`` / ``noexcept`` /
    ``override``) outside any function body."""
    out: List[Function] = []
    i, n = 0, len(code)
    header_start = 0
    while i < n:
        c = code[i]
        if c in ";}":
            header_start = i + 1
        elif c == "{":
            head = code[header_start:i]
            tail = _strip_qualifiers(head)
            end = _match(code, i, "{", "}")
            if tail.endswith(")"):
                depth, k = 0, len(tail) - 1
                while k >= 0:
                    depth += {")": 1, "(": -1}.get(tail[k], 0)
                    if depth == 0:
                        break
                    k -= 1
                a = _ident_before(tail, k)
                if a >= 0:
                    out.append(Function(tail[a:k].strip().split("::")[-1],
                                        head, i + 1, end - 1,
                                        "__global__" in head))
                    i = end
                    header_start = end
                    continue
            header_start = i + 1
        i += 1
    return out


def constants(code: str, funcs: List[Function], env: Dict[str, int],
              namespaces: Iterable[str]) -> Dict[str, int]:
    """``constexpr`` integers of the blanked text outside every function
    of ``funcs`` (folded with
    :func:`repro_torch.analysis.astutil.const_int`; template ones stay
    unresolved), added to a copy of ``env``."""
    env = dict(env)
    spans = [(f.start, f.end) for f in funcs]
    for m in _CONSTEXPR_RE.finditer(code):
        if any(a <= m.start() < b for a, b in spans):
            continue
        v = fold(m.group(2), env, namespaces)
        if v is not None:
            env[m.group(1)] = v
    return env


def fold(expr: str, env: Dict[str, int],
         namespaces: Iterable[str]) -> Optional[int]:
    """An integer expression of literals and ``env`` names (integer
    suffixes and the qualifiers of ``namespaces`` dropped; ``T::X`` of a
    template parameter stays unresolved), or None."""
    text = _INT_SUFFIX_RE.sub(r"\1", expr.strip())
    text = re.sub(r"\b(\w+)::", lambda m: "" if m.group(1) in namespaces
                  else m.group(0), text)
    try:
        tree = ast.parse(text, mode="eval")
    except SyntaxError:
        return None
    return astutil.const_int(tree.body, env)


class _Source:
    """One file's blanked text, functions, line index, and what its local
    headers add: constants and the kernels' ``__launch_bounds__``."""

    def __init__(self, path: str, source: str,
                 cache: Dict[str, "_Source"]):
        self.code = blank_noncode(source)
        self.funcs = functions(self.code)
        self.newlines = [k for k, c in enumerate(self.code) if c == "\n"]
        env: Dict[str, int] = {}
        self.bounds: Dict[str, str] = {}
        self.namespaces = set(_NAMESPACE_RE.findall(self.code))
        for inc in _INCLUDE_RE.findall(source):
            header = _load(os.path.join(os.path.dirname(path), inc), cache)
            if header is not None:
                env.update(header.env)
                self.bounds.update(header.bounds)
                self.namespaces |= header.namespaces
        self.env = constants(self.code, self.funcs, env, self.namespaces)
        for f in self.funcs:
            m = _BOUNDS_RE.search(f.header)
            if f.kernel and m:
                self.bounds[f.name] = m.group(1).strip()

    def line(self, offset: int) -> int:
        return bisect.bisect_left(self.newlines, offset) + 1


def _load(path: str, cache: Dict[str, _Source]) -> Optional[_Source]:
    path = os.path.normpath(path)
    if path not in cache:
        try:
            with open(path, encoding="utf-8") as f:
                text = f.read()
        except OSError:
            return None
        cache[path] = None                       # guards include cycles
        cache[path] = _Source(path, text, cache)
    return cache[path]


@dataclasses.dataclass
class Launch:
    kernel: str          # the kernel's text, template arguments included
    base: str            # its name without them
    config: List[str]    # grid, block, smem, stream
    offset: int


def launches(code: str, start: int, end: int) -> List[Launch]:
    """The ``<<<...>>>`` launches in ``code[start:end]``."""
    out = []
    k = code.find("<<<", start, end)
    while k >= 0:
        j = k - 1
        while j >= start and code[j].isspace():
            j -= 1
        if code[j] == ">":                    # template arguments
            depth = 0
            while j >= start:
                depth += {">": 1, "<": -1}.get(code[j], 0)
                if depth == 0:
                    break
                j -= 1
            j -= 1
        a = _ident_before(code, j + 1, start)
        close = code.find(">>>", k + 3, end)
        if a >= 0 and close > 0:
            kernel = _norm(code[a:k])
            base = re.match(r"[\w:]+", kernel).group(0)
            out.append(Launch(kernel, base.split("::")[-1],
                              split_args(code[k + 3:close]), k))
        k = code.find("<<<", k + 3, end)
    return out


def _statement_prefix(code: str, start: int, at: int) -> str:
    """The text of the statement holding ``at``, up to ``at``."""
    k = at
    while k > start and code[k - 1] not in ";{}":
        k -= 1
    return code[k:at]


def _tested_after(code: str, var: str, at: int, end: int) -> bool:
    """Whether an ``if (...)`` condition in ``code[at:end]`` names
    ``var``."""
    for m in re.finditer(r"\bif\s*\(", code[at:end]):
        open_ = at + m.end() - 1
        cond = code[open_:_match(code, open_, "(", ")")]
        if re.search(r"\b%s\b" % re.escape(var), cond):
            return True
    return False


@dataclasses.dataclass
class OptIn:
    kernel: str
    smem: bool           # sets MaxDynamicSharedMemorySize
    checked: bool
    offset: int


def opt_ins(code: str, fn: Function) -> List[OptIn]:
    """Every ``cudaFuncSetAttribute`` call in ``fn`` and whether its
    result is checked."""
    out = []
    for m in re.finditer(r"\bcudaFuncSetAttribute\s*\(",
                         code[fn.start:fn.end]):
        at = fn.start + m.start()
        open_ = fn.start + m.end() - 1
        close = _match(code, open_, "(", ")")
        args = split_args(code[open_ + 1:close - 1])
        prefix = _statement_prefix(code, fn.start, at).strip()
        assign = re.search(r"(\w+)\s*=$", prefix)
        if assign:
            checked = _tested_after(code, assign.group(1), close, fn.end)
        else:
            checked = prefix not in ("", "(void)")
        out.append(OptIn(_norm(args[0]) if args else "",
                         len(args) > 1 and SMEM_ATTRIBUTE in args[1],
                         checked, at))
    return out


class CudaLaunchRule(Rule):
    """Launch hygiene of the hand-written kernels: shared-memory opt-in,
    checked attributes, read launch errors, block size within the
    kernel's launch bounds."""

    rule_id = "RL004"
    name = "cuda-launch"
    reads_cuda = True

    def check_cuda(self, ctx: CudaContext) -> Iterable[Finding]:
        src = _Source(ctx.path, ctx.source, {})
        code = src.code
        findings: List[Finding] = []

        def add(offset: int, msg: str) -> None:
            findings.append(Finding(self.rule_id, ctx.path,
                                    src.line(offset), msg))

        for fn in src.funcs:
            if fn.kernel:
                continue
            sets = opt_ins(code, fn)
            for s in sets:
                if not s.checked:
                    add(s.offset, f"`cudaFuncSetAttribute({s.kernel}, ...)` "
                        f"in `{fn.name}`: its result is dropped — the "
                        f"opt-in can fail, and the launch after it then "
                        f"fails for a reason nobody reads; return or test "
                        f"the cudaError_t")
            for ln in launches(code, fn.start, fn.end):
                findings.extend(self._check_launch(ctx, src, fn, ln, sets))
        return findings

    def _check_launch(self, ctx: CudaContext, src: _Source, fn: Function,
                      ln: Launch, sets: List[OptIn]) -> List[Finding]:
        out = []
        line = src.line(ln.offset)
        smem_text = ln.config[2] if len(ln.config) > 2 else "0"
        smem = fold(smem_text, src.env, src.namespaces)
        if smem is None or smem > SMEM_LIMIT:
            if not any(s.smem and s.checked and s.kernel == ln.kernel
                       and s.offset < ln.offset for s in sets):
                out.append(Finding(
                    self.rule_id, ctx.path, line,
                    f"`{ln.kernel}` launched in `{fn.name}` with dynamic "
                    f"shared memory `{smem_text}` "
                    f"({'not resolved' if smem is None else smem} bytes), "
                    f"with no checked `cudaFuncSetAttribute({ln.kernel}, "
                    f"{SMEM_ATTRIBUTE}, ...)` before it: above "
                    f"{SMEM_LIMIT} bytes the launch fails without "
                    f"the opt-in"))
        if not self._error_read(src, fn, ln.offset):
            out.append(Finding(
                self.rule_id, ctx.path, line,
                f"`{ln.kernel}` launched in `{fn.name}`, and neither "
                f"`{fn.name}` nor every caller of it in this file reads "
                f"`cudaGetLastError()` after the launch: a failed launch "
                f"reaches no wrapper (build.check raises only on the "
                f"status the entry point returns)"))
        bound = src.bounds.get(ln.base)
        limit = None if bound is None else fold(bound, src.env,
                                                src.namespaces)
        block = (fold(ln.config[1], src.env, src.namespaces)
                 if len(ln.config) > 1 else None)
        if limit is not None and block is not None and block > limit:
            out.append(Finding(
                self.rule_id, ctx.path, line,
                f"`{ln.kernel}` launched with {block} threads a block, "
                f"above its __launch_bounds__({bound}) = {limit}: the "
                f"launch fails with too many resources requested"))
        return out

    @staticmethod
    def _error_read(src: _Source, fn: Function, offset: int) -> bool:
        code = src.code

        def reads(a: int, b: int) -> bool:
            return any(re.search(r"\b%s\b" % r, code[a:b])
                       for r in ERROR_READS)

        if reads(offset, fn.end):
            return True
        callers = []
        for g in src.funcs:
            if g is fn:
                continue
            for m in re.finditer(r"\b%s\b" % re.escape(fn.name),
                                 code[g.start:g.end]):
                callers.append((g, g.start + m.end()))
        return bool(callers) and all(reads(at, g.end) for g, at in callers)
