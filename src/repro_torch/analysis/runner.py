"""Pass orchestration of the port's lint: build the model once, run the
passes, apply the baseline — the port's copy of
``repro/analysis/runner.py``.

``run_analysis_torch`` is the library face (used by the CLI and
``tests/test_torch_analysis.py``); every pass also exposes a bare
``run_<pass>_torch(model, ...)`` so fixture tests can drive it against
synthetic trees with miniature contract tables.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from . import (axis_threading, contracts, docstrings, host_sync,
               kernel_triples, observability)
from .findings import (LintFinding, LintSeverity, apply_baseline_torch,
                       gate_count_torch, load_baseline_torch)
from .model import PortRepoModel


def _axes_torch(model: PortRepoModel) -> List[LintFinding]:
    return axis_threading.run_axis_threading_torch(
        model, contracts.AXES, contracts.ENTRY_POINTS,
        contracts.STATIC_ARGNAME_MODULES, contracts.STATIC_NON_AXES)


def _host_sync_torch(model: PortRepoModel) -> List[LintFinding]:
    cfg = contracts.HOST_SYNC
    return host_sync.run_host_sync_torch(
        model, cfg["scan_dirs"], cfg["root_patterns"], cfg["host_gates"])


def _kernels_torch(model: PortRepoModel) -> List[LintFinding]:
    return kernel_triples.run_kernel_triples_torch(model, contracts.KERNELS)


def _observability_torch(model: PortRepoModel) -> List[LintFinding]:
    return observability.run_observability_torch(model,
                                                  contracts.OBSERVABILITY)


def _docstrings_torch(model: PortRepoModel) -> List[LintFinding]:
    return docstrings.run_docstrings_torch(model, contracts.DOCSTRINGS)


#: pass name -> runner, in report order (``host-sync`` takes the place of
#: the reference's ``jit-purity``)
PASSES = {
    "axis-threading": _axes_torch,
    "host-sync": _host_sync_torch,
    "kernel-triples": _kernels_torch,
    "observability": _observability_torch,
    "docstrings": _docstrings_torch,
}


@dataclasses.dataclass
class LintReport:
    """Everything one analysis run produced."""

    findings: List[LintFinding]
    stale_baseline: List[str]
    passes: List[str]

    @property
    def gate_failure_count(self) -> int:
        """Unbaselined errors — what ``--check`` exits non-zero on."""
        return gate_count_torch(self.findings)

    def as_json(self) -> dict:
        """Machine-readable report (the CI artifact)."""
        by_code: Dict[str, int] = {}
        for f in self.findings:
            by_code[f.code] = by_code.get(f.code, 0) + 1
        return {
            "passes": self.passes,
            "summary": {
                "total": len(self.findings),
                "baselined": sum(1 for f in self.findings if f.baselined),
                "gate_failures": self.gate_failure_count,
                "by_code": dict(sorted(by_code.items())),
                "stale_baseline": self.stale_baseline,
            },
            "findings": [f.as_dict() for f in self.findings],
        }

    def render_report(self) -> str:
        """Human-readable report grouped by pass."""
        lines: List[str] = []
        for name in self.passes:
            group = [f for f in self.findings if f.pass_name == name]
            live = [f for f in group if not f.baselined
                    and f.severity == LintSeverity.ERROR]
            tag = "OK" if not live else f"{len(live)} error(s)"
            lines.append(f"[{name}] {tag} "
                         f"({len(group)} finding(s), "
                         f"{sum(1 for f in group if f.baselined)} "
                         f"baselined)")
            for f in sorted(group, key=lambda f: (f.file, f.line, f.code)):
                lines.append(f"  {f.render_line()}")
                if f.baselined:
                    lines.append(f"    waived: {f.baseline_reason}")
        for key in self.stale_baseline:
            lines.append(f"  BL001 [warn] stale baseline entry: {key} "
                         f"matches no finding — delete it")
        lines.append(
            f"analysis: {len(self.findings)} finding(s), "
            f"{self.gate_failure_count} gate failure(s)"
            + (f", {len(self.stale_baseline)} stale baseline entr(y/ies)"
               if self.stale_baseline else ""))
        return "\n".join(lines)


def run_analysis_torch(root: Path, passes: Optional[Sequence[str]] = None,
                       baseline_path: Optional[Path] = None,
                       model: Optional[PortRepoModel] = None) -> LintReport:
    """Run the suite on the port in the repo at ``root`` and apply the
    baseline."""
    root = Path(root)
    names = list(passes) if passes else list(PASSES)
    unknown = [n for n in names if n not in PASSES]
    if unknown:
        raise ValueError(f"unknown pass(es) {unknown}; available: "
                         f"{', '.join(PASSES)}")
    if model is None:
        model = PortRepoModel.load_port(root)
    findings: List[LintFinding] = []
    for name in names:
        findings.extend(PASSES[name](model))
    if baseline_path is None:
        baseline_path = root / contracts.BASELINE_PATH
    baseline = load_baseline_torch(baseline_path)
    findings, stale = apply_baseline_torch(findings, baseline)
    return LintReport(findings=findings, stale_baseline=stale, passes=names)


def write_json_torch(report: LintReport, path: Path) -> None:
    """Write the JSON artifact (parent dirs created)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report.as_json(), indent=2) + "\n")
