"""Finding, severity and baseline machinery shared by every pass of the
port's lint — the port's copy of ``repro/analysis/findings.py``.

A finding is keyed by ``code:file:symbol`` (line numbers excluded on
purpose: a baseline entry should survive unrelated edits that shift lines).
The committed baseline (``src/repro_torch/analysis/baseline.json``) is a
list of ``{"code", "file", "symbol", "reason"}`` entries; every entry must
carry a non-empty one-line ``reason``. Stale entries (matching nothing) are
reported as ``BL001`` warnings so the baseline cannot silently accrete.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, List, Tuple


class LintSeverity:
    """Two-level severity: ``--check`` gates on unbaselined errors only."""

    ERROR = "error"
    WARN = "warn"


@dataclasses.dataclass
class LintFinding:
    """One diagnostic emitted by a pass.

    ``file`` is repo-relative posix; ``symbol`` is the qualified name (or
    contract key) the finding is about, and is part of the baseline key.
    """

    code: str
    severity: str
    file: str
    line: int
    symbol: str
    message: str
    pass_name: str = ""
    baselined: bool = False
    baseline_reason: str = ""

    @property
    def baseline_key(self) -> str:
        """Baseline-matching key; deliberately excludes the line number."""
        return f"{self.code}:{self.file}:{self.symbol}"

    def as_dict(self) -> dict:
        """JSON-friendly representation (used by ``--json``)."""
        return dataclasses.asdict(self)

    def render_line(self) -> str:
        """One-line text rendering: ``file:line CODE [sev] symbol: msg``."""
        tag = "baselined" if self.baselined else self.severity
        return (f"{self.file}:{self.line}: {self.code} [{tag}] "
                f"{self.symbol}: {self.message}")


def load_baseline_torch(path: Path) -> Dict[str, str]:
    """Load the committed baseline file into a ``key -> reason`` map.

    Missing file means an empty baseline. Entries without a reason are a
    configuration error: the whole point of the baseline is the recorded
    justification.
    """
    if not Path(path).exists():
        return {}
    entries = json.loads(Path(path).read_text())
    baseline: Dict[str, str] = {}
    for e in entries:
        reason = str(e.get("reason", "")).strip()
        if not reason:
            raise ValueError(
                f"baseline entry {e!r} has no reason; every waived finding "
                f"needs a one-line justification")
        baseline[f"{e['code']}:{e['file']}:{e['symbol']}"] = reason
    return baseline


def apply_baseline_torch(findings: Iterable[LintFinding],
                         baseline: Dict[str, str],
                         ) -> Tuple[List[LintFinding], List[str]]:
    """Mark baselined findings in place; return (findings, stale_keys)."""
    out = list(findings)
    used = set()
    for f in out:
        reason = baseline.get(f.baseline_key)
        if reason is not None:
            f.baselined = True
            f.baseline_reason = reason
            used.add(f.baseline_key)
    stale = sorted(set(baseline) - used)
    return out, stale


def gate_count_torch(findings: Iterable[LintFinding]) -> int:
    """Number of findings that fail ``--check``: unbaselined errors."""
    return sum(1 for f in findings
               if not f.baselined and f.severity == LintSeverity.ERROR)
