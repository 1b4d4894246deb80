"""Observability-coverage pass of the port's lint (codes ``OB4xx``) — the
port's copy of ``repro/analysis/observability.py``, over the port's
``SolveInfo`` (``core/solveinfo.py``) and ``ChurnRecord``
(``sched/churn.py``).

For each telemetry dataclass in ``contracts.OBSERVABILITY`` (``SolveInfo``,
``ChurnRecord``): collect its fields from the class body, collect writers
per declared backend group (constructor calls — positional args mapped to
field order, keywords by name, ``from_residual(...)`` implies the
residual-derived fields — plus ``obj.field = ...`` attribute stores on
non-``self`` targets), and require every field to be written by every
group or explicitly waived with a one-line justification.

Finding codes::

    OB401  field never written anywhere (dead telemetry)
    OB402  field not populated by a backend group and not waived
    OB403  waiver references a field/group that does not exist (stale)
"""
from __future__ import annotations

import ast
from typing import Dict, List, Set

from .findings import LintFinding, LintSeverity
from .model import PortRepoModel, call_base_name_torch

PASS_NAME = "observability"

#: fields SolveInfo.from_residual derives itself from (rounds, resid,
#: scale, tol, loose_tol) before forwarding **kw to the constructor —
#: rounds_to_tol is derived there too (rounds iff the tight tol certified)
_FROM_RESIDUAL_FIELDS = {"rounds", "converged", "residual", "approx",
                         "rounds_to_tol"}


def _finding_torch(code: str, file: str, line: int, symbol: str, msg: str,
                   severity: str = LintSeverity.ERROR) -> LintFinding:
    return LintFinding(code=code, severity=severity, file=file, line=line,
                       symbol=symbol, message=msg, pass_name=PASS_NAME)


def _class_fields_torch(model: PortRepoModel, module_rel: str,
                        cls_name: str) -> List[str]:
    mod = model.modules.get(module_rel)
    if mod is None:
        return []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and node.name == cls_name:
            return [item.target.id for item in node.body
                    if isinstance(item, ast.AnnAssign)
                    and isinstance(item.target, ast.Name)]
    return []


def _writers_torch(model: PortRepoModel, rel: str, cls_name: str,
                   fields: List[str]) -> Set[str]:
    """Field names this module populates for ``cls_name`` instances."""
    mod = model.modules.get(rel)
    written: Set[str] = set()
    if mod is None:
        return written
    field_set = set(fields)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            base = call_base_name_torch(node)
            if base == cls_name:
                for i, _ in enumerate(node.args):
                    if i < len(fields):
                        written.add(fields[i])
                for kw in node.keywords:
                    if kw.arg in field_set:
                        written.add(kw.arg)
            elif base == "from_residual" and isinstance(
                    node.func, ast.Attribute):
                owner = node.func.value
                if isinstance(owner, ast.Name) and owner.id == cls_name:
                    written |= _FROM_RESIDUAL_FIELDS & field_set
                    for kw in node.keywords:
                        if kw.arg in field_set:
                            written.add(kw.arg)
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                if isinstance(tgt, ast.Attribute) \
                        and tgt.attr in field_set \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id != "self":
                    written.add(tgt.attr)
    return written


def run_observability_torch(model: PortRepoModel,
                            config: Dict) -> List[LintFinding]:
    """Check field coverage for every declared telemetry class."""
    findings: List[LintFinding] = []
    for cls_name, spec in config.items():
        fields = _class_fields_torch(model, spec["module"], cls_name)
        if not fields:
            findings.append(_finding_torch(
                "OB403", spec["module"], 1, cls_name,
                f"contracts.OBSERVABILITY references {cls_name!r} in "
                f"{spec['module']}, which has no such dataclass"))
            continue
        waivers = spec.get("waivers", {})
        field_set = set(fields)
        for (wf, wg), _reason in waivers.items():
            if wf not in field_set or wg not in spec["writer_groups"]:
                findings.append(_finding_torch(
                    "OB403", spec["module"], 1, f"{cls_name}.{wf}[{wg}]",
                    f"stale waiver: {cls_name} has no field {wf!r} / "
                    f"group {wg!r}"))
        group_written: Dict[str, Set[str]] = {}
        for group, rels in spec["writer_groups"].items():
            written: Set[str] = set()
            for rel in rels:
                written |= _writers_torch(model, rel, cls_name, fields)
            group_written[group] = written
        all_written = set().union(*group_written.values()) \
            if group_written else set()
        for field in fields:
            if field not in all_written:
                findings.append(_finding_torch(
                    "OB401", spec["module"], 1, f"{cls_name}.{field}",
                    f"telemetry field {field!r} is never populated by any "
                    f"backend — dead observability"))
                continue
            for group, written in group_written.items():
                if field in written:
                    continue
                if (field, group) in waivers:
                    continue
                findings.append(_finding_torch(
                    "OB402", spec["module"], 1,
                    f"{cls_name}.{field}[{group}]",
                    f"field {field!r} is not populated by the {group!r} "
                    f"backend and carries no waiver in "
                    f"contracts.OBSERVABILITY"))
    return findings
