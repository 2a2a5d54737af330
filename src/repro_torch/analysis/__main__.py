"""CLI for ``repro_torch.analysis``: ``python -m repro_torch.analysis
[paths...]``.

Exit code 0 when clean, 1 when there are findings (CI gates on it),
2 on usage errors.  ``--json`` emits a machine-readable report.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence

from repro_torch.analysis.engine import LintEngine
from repro_torch.analysis.rules import RULE_CLASSES, build_rules

#: what the port's linter gates by default: the port, the tests and the
#: card smoke, never the reference package ``src/repro``
DEFAULT_PATHS = ("src/repro_torch", "tests", "chip_smoke.py")


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST and CUDA-source linter for the PyTorch/CUDA "
                    "port's bug classes (rule catalog: "
                    "repro_torch.analysis)")
    parser.add_argument(
        "paths", nargs="*",
        help=f"files or directories to lint, relative to --root "
             f"(default: {' '.join(DEFAULT_PATHS)})")
    parser.add_argument(
        "--root", default=".",
        help="repo root: anchors relative paths and the docs catalog "
             "(default: cwd)")
    parser.add_argument(
        "--json", action="store_true", dest="as_json",
        help="emit the report as JSON instead of human-readable lines")
    parser.add_argument(
        "--select", action="append", default=None, metavar="RULE",
        help="run only these rule ids (repeatable, e.g. --select RL007)")
    parser.add_argument(
        "--list-rules", action="store_true",
        help="list rule ids and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule_id, cls in sorted(RULE_CLASSES.items()):
            print(f"{rule_id} {cls.name}")
        return 0

    if args.select:
        unknown = sorted(set(args.select) - set(RULE_CLASSES))
        if unknown:
            print(f"unknown rule id(s): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2

    root = os.path.abspath(args.root)
    paths = args.paths or [
        os.path.relpath(os.path.join(root, p)) for p in DEFAULT_PATHS
        if os.path.exists(os.path.join(root, p))]
    engine = LintEngine(build_rules(root, select=args.select), root=root)
    result = engine.run(paths)
    if args.as_json:
        print(result.to_json())
    else:
        print(result.format_human())
    return result.exit_code


if __name__ == "__main__":
    sys.exit(main())
