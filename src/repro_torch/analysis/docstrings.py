"""Docstring-coverage pass of the port's lint (codes ``DS5xx``) — the
port's copy of ``repro/analysis/docstrings.py``, over the port's
``core`` and ``sched`` packages.

Public symbols carry their own docstrings (the docs point readers into
the code): PRESENCE on public symbols, not style.

Public = the module itself, plus every module-level function, class, and
method whose name doesn't start with ``_`` (dunders are private here —
``__init__`` is documented by its class). Closures are skipped; a public
method on a private class still counts.

Finding codes::

    DS501  package-set coverage below the floor (gates --check)
    DS502  individual public symbol without a docstring (warn)
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Tuple

from .findings import LintFinding, LintSeverity
from .model import PortRepoModel

PASS_NAME = "docstrings"

_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def audit_module_torch(tree: ast.Module, rel: str
                       ) -> Iterator[Tuple[str, int, bool]]:
    """Yield ``(symbol, line, has_docstring)`` for the module's public API."""
    yield f"{rel} (module)", 1, ast.get_docstring(tree) is not None
    stack = [node for node in tree.body if isinstance(node, _DEFS)]
    while stack:
        node = stack.pop()
        if isinstance(node, ast.ClassDef):
            # methods and nested classes are API; closures below are not
            stack.extend(n for n in node.body if isinstance(n, _DEFS))
        if not node.name.startswith("_"):
            yield (f"{node.name}", node.lineno,
                   ast.get_docstring(node) is not None)


def coverage_torch(model: PortRepoModel, packages: Tuple[str, ...]
                   ) -> Tuple[int, int, List[Tuple[str, str, int]]]:
    """(total, documented, missing [(rel, symbol, line), ...]) across the
    top-level modules of the given packages."""
    total, documented = 0, 0
    missing: List[Tuple[str, str, int]] = []
    for pkg in packages:
        prefix = pkg.rstrip("/") + "/"
        for rel, mod in sorted(model.modules.items()):
            if not rel.startswith(prefix) \
                    or "/" in rel[len(prefix):]:
                continue
            for symbol, line, ok in audit_module_torch(mod.tree, rel):
                total += 1
                documented += ok
                if not ok:
                    missing.append((rel, symbol, line))
    return total, documented, missing


def run_docstrings_torch(model: PortRepoModel,
                         config: Dict) -> List[LintFinding]:
    """Coverage floor over the configured package set."""
    packages = tuple(config["packages"])
    floor = float(config["min_percent"])
    total, documented, missing = coverage_torch(model, packages)
    pct = 100.0 * documented / total if total else 100.0
    findings = [
        LintFinding(code="DS502", severity=LintSeverity.WARN, file=rel,
                    line=line,
                symbol=symbol, message="public symbol has no docstring",
                pass_name=PASS_NAME)
        for rel, symbol, line in missing
    ]
    if pct < floor:
        findings.insert(0, LintFinding(
            code="DS501", severity=LintSeverity.ERROR,
            file=packages[0], line=1, symbol="coverage",
            message=f"docstring coverage {pct:.1f}% is below the "
                    f"{floor:.1f}% floor ({documented}/{total} public "
                    f"symbols documented across {', '.join(packages)})",
            pass_name=PASS_NAME))
    return findings
