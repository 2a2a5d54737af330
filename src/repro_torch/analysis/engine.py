"""Rule engine for the port's invariant linter.

The engine is deliberately dumb plumbing: it walks ``*.py`` files, parses
each once with :mod:`ast`, hands every module to every rule, collects
:class:`Finding`\\ s, and applies inline suppressions.  Rules that declare
``reads_cuda`` also get every ``*.cu`` / ``*.cuh`` file as text (there is
no C++ parser here: those rules read the source themselves).  All
bug-class knowledge lives in :mod:`repro_torch.analysis.rules`.

Suppression contract
--------------------
A finding on line ``L`` is silenced by a comment on line ``L`` or the
line directly above::

    # repro-lint: disable=RL001 -- forward-pass all-gather, transpose
    #                              is the reduce-scatter (exact cotangent)

and in a CUDA source by the same comment after ``//``::

    // repro-lint: disable=RL004 -- the caller checks cudaGetLastError()

The justification after ``--`` is REQUIRED: a disable without one (the
same comment with nothing after the rule ids) does **not** suppress
anything and is itself reported (``RL000``) — the whole point is that
every deliberate exception carries its reasoning in the diff.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Sequence

#: Engine-level diagnostics (parse failures, malformed suppressions).
ENGINE_RULE_ID = "RL000"

_IDS_AND_REASON = (r"repro-lint:\s*disable=([A-Za-z0-9_*,\s]+?)"
                   r"(?:\s*--\s*(\S.*))?$")
SUPPRESS_RE = re.compile(r"#\s*" + _IDS_AND_REASON)
CUDA_SUPPRESS_RE = re.compile(r"//\s*" + _IDS_AND_REASON)

#: Suffixes of the CUDA sources that rules with ``reads_cuda`` read.
CUDA_SUFFIXES = (".cu", ".cuh")

#: Directory fragments never linted (the fixture corpora are *made of*
#: violations; linting them would defeat the repo-wide clean gate).  The
#: fragment also covers ``fixtures/analysis_torch``.
DEFAULT_EXCLUDES = ("fixtures" + os.sep + "analysis",
                    "__pycache__", ".git")


@dataclasses.dataclass
class Finding:
    """One rule violation at a source location.

    ``path`` is kept exactly as the walker produced it (relative paths in
    CLI runs stay relative, so output lines are clickable from the repo
    root); ``line`` is 1-indexed.
    """
    rule: str
    path: str
    line: int
    message: str
    severity: str = "error"

    def format(self) -> str:
        """Render as the canonical ``file:line: severity RL00x message``."""
        return (f"{self.path}:{self.line}: "
                f"{self.severity} {self.rule} {self.message}")

    def to_dict(self) -> dict:
        """JSON-safe dict; inverse of :meth:`from_dict`."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Finding":
        """Rebuild a finding from :meth:`to_dict` output (round-trips)."""
        return cls(**d)


@dataclasses.dataclass
class ModuleContext:
    """Everything a rule gets per Python file: parsed tree + raw text.

    ``relpath`` is the path relative to the engine root with ``/``
    separators — rules use it for scope filters (e.g. RL007 reads only
    modules under a ``kernels`` directory).
    """
    path: str
    relpath: str
    source: str
    lines: List[str]
    tree: ast.AST


@dataclasses.dataclass
class CudaContext:
    """Everything a ``reads_cuda`` rule gets per ``.cu`` / ``.cuh`` file:
    the raw text, its lines, and the path as :class:`ModuleContext` keeps
    it."""
    path: str
    relpath: str
    source: str
    lines: List[str]


class Rule:
    """Base class for lint rules.

    Subclasses set ``rule_id`` / ``name`` / ``severity`` and implement
    :meth:`check_module`; a rule that reads CUDA sources sets
    ``reads_cuda`` and implements :meth:`check_cuda`; rules needing
    whole-run state (RL005 compares source against a docs catalog) also
    implement :meth:`finalize`, called once after every file was visited.
    """

    rule_id = ENGINE_RULE_ID
    name = "engine"
    severity = "error"
    reads_cuda = False

    def check_module(self, ctx: ModuleContext) -> Iterable[Finding]:
        """Yield findings for one parsed module."""
        return ()

    def check_cuda(self, ctx: CudaContext) -> Iterable[Finding]:
        """Yield findings for one CUDA source (``reads_cuda`` rules)."""
        return ()

    def finalize(self) -> Iterable[Finding]:
        """Yield cross-file findings after the walk completes."""
        return ()


@dataclasses.dataclass
class LintResult:
    """Outcome of one engine run: active findings, silenced findings
    (justified suppressions, kept for reporting), the file count, and
    the files by kind (``py`` and ``cuda``)."""
    findings: List[Finding]
    suppressed: List[Finding]
    files_checked: int
    files_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def exit_code(self) -> int:
        """Process exit status: non-zero iff any unsuppressed finding."""
        return 1 if self.findings else 0

    def to_json(self) -> str:
        """Serialize the full result (findings round-trip through
        :meth:`Finding.from_dict`)."""
        return json.dumps({
            "findings": [f.to_dict() for f in self.findings],
            "suppressed": [f.to_dict() for f in self.suppressed],
            "files_checked": self.files_checked,
            "files_by_kind": self.files_by_kind,
        }, indent=2)

    def format_human(self) -> str:
        """Render the result the way a compiler would: one line per
        finding, then a one-line summary."""
        out = [f.format() for f in self.findings]
        kinds = ", ".join(f"{n} {k}" for k, n in
                          sorted(self.files_by_kind.items()))
        out.append(
            f"repro-lint: {len(self.findings)} finding(s), "
            f"{len(self.suppressed)} suppressed, "
            f"{self.files_checked} files checked ({kinds})")
        return "\n".join(out)


def is_cuda(path: str) -> bool:
    """Whether ``path`` names a CUDA source (``.cu`` / ``.cuh``)."""
    return path.endswith(CUDA_SUFFIXES)


def _parse_suppression(line: str, cuda: bool = False):
    """Return ``(rule_ids, justification)`` for a suppression comment on
    ``line`` (``//`` in a CUDA source, ``#`` elsewhere), or ``None``.
    ``rule_ids`` may contain ``"*"``."""
    m = (CUDA_SUPPRESS_RE if cuda else SUPPRESS_RE).search(line)
    if not m:
        return None
    ids = {tok.strip() for tok in m.group(1).split(",") if tok.strip()}
    just = (m.group(2) or "").strip()
    return ids, just


class LintEngine:
    """Walks paths, runs rules, applies suppressions.

    Args:
        rules: rule instances to run (the full registry comes from
            :func:`repro_torch.analysis.rules.build_rules`, resolved by
            the caller — the engine itself has no rule knowledge).
        root: directory ``relpath`` values are computed against.
        excludes: path fragments (OS separators) that disable linting
            for any file whose path contains them.

    CUDA sources are collected only when a rule has ``reads_cuda``.
    """

    def __init__(self, rules: Sequence[Rule], root: str = ".",
                 excludes: Sequence[str] = DEFAULT_EXCLUDES):
        self.rules = list(rules)
        self.root = os.path.abspath(root)
        self.excludes = tuple(excludes)
        self.suffixes = (".py",) + (
            CUDA_SUFFIXES if any(r.reads_cuda for r in self.rules) else ())
        self._line_cache: Dict[str, List[str]] = {}

    # -- file discovery ----------------------------------------------------
    def _excluded(self, path: str) -> bool:
        norm = os.path.normpath(path)
        return any(frag in norm for frag in self.excludes)

    def collect_files(self, paths: Sequence[str]) -> List[str]:
        """Expand files/directories into the sorted work list of ``*.py``
        (and, with a CUDA rule, ``*.cu`` / ``*.cuh``) files."""
        out = []
        for p in paths:
            if os.path.isdir(p):
                for dirpath, dirnames, filenames in os.walk(p):
                    dirnames[:] = sorted(
                        d for d in dirnames
                        if not self._excluded(os.path.join(dirpath, d)))
                    for fn in sorted(filenames):
                        full = os.path.join(dirpath, fn)
                        if fn.endswith(self.suffixes) \
                                and not self._excluded(full):
                            out.append(full)
            elif p.endswith(self.suffixes) and not self._excluded(p):
                out.append(p)
        return out

    # -- core run ----------------------------------------------------------
    def run(self, paths: Sequence[str]) -> LintResult:
        """Lint every collected file under ``paths`` and return the
        result."""
        files = self.collect_files(paths)
        raw: List[Finding] = []
        kinds = {"py": 0, "cuda": 0} if len(self.suffixes) > 1 else {"py": 0}
        for path in files:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            lines = source.splitlines()
            self._line_cache[path] = lines
            relpath = os.path.relpath(os.path.abspath(path),
                                      self.root).replace(os.sep, "/")
            if is_cuda(path):
                kinds["cuda"] += 1
                cctx = CudaContext(path=path, relpath=relpath,
                                   source=source, lines=lines)
                for rule in self.rules:
                    if rule.reads_cuda:
                        raw.extend(rule.check_cuda(cctx))
                raw.extend(self._check_suppression_comments(path, lines))
                continue
            kinds["py"] += 1
            try:
                tree = ast.parse(source, filename=path)
            except SyntaxError as e:
                raw.append(Finding(ENGINE_RULE_ID, path, e.lineno or 1,
                                   f"syntax error: {e.msg}"))
                continue
            ctx = ModuleContext(path=path, relpath=relpath, source=source,
                                lines=lines, tree=tree)
            for rule in self.rules:
                raw.extend(rule.check_module(ctx))
            raw.extend(self._check_suppression_comments(path, lines))
        for rule in self.rules:
            raw.extend(rule.finalize())
        findings, suppressed = self._apply_suppressions(raw)
        findings.sort(key=lambda f: (f.path, f.line, f.rule))
        suppressed.sort(key=lambda f: (f.path, f.line, f.rule))
        return LintResult(findings, suppressed, len(files), kinds)

    # -- suppressions ------------------------------------------------------
    def _check_suppression_comments(self, path: str,
                                    lines: List[str]) -> List[Finding]:
        """Every suppression comment must carry a justification — a bare
        ``disable=`` is a finding itself and silences nothing."""
        out = []
        cuda = is_cuda(path)
        for i, line in enumerate(lines, start=1):
            parsed = _parse_suppression(line, cuda)
            if parsed is not None and not parsed[1]:
                out.append(Finding(
                    ENGINE_RULE_ID, path, i,
                    "bare `repro-lint: disable` without a justification "
                    "(`-- <reason>`) suppresses nothing — state why the "
                    "exception is safe"))
        return out

    def _suppression_for(self, path: str, line: int):
        lines = self._line_cache.get(path)
        if lines is None:
            try:
                with open(path, encoding="utf-8") as f:
                    lines = f.read().splitlines()
            except OSError:
                lines = []
            self._line_cache[path] = lines
        cuda = is_cuda(path)
        for ln in (line, line - 1):
            if 1 <= ln <= len(lines):
                parsed = _parse_suppression(lines[ln - 1], cuda)
                if parsed is not None:
                    return parsed
        return None

    def _apply_suppressions(self, raw: List[Finding]):
        findings, suppressed = [], []
        for f in raw:
            if f.rule == ENGINE_RULE_ID:      # engine findings never hide
                findings.append(f)
                continue
            parsed = self._suppression_for(f.path, f.line)
            if parsed is not None:
                ids, just = parsed
                if just and (f.rule in ids or "*" in ids):
                    suppressed.append(f)
                    continue
            findings.append(f)
        return findings, suppressed
