"""Axis-threading drift pass of the port's lint (codes ``AX1xx``) — the
port's copy of ``repro/analysis/axis_threading.py``, run over the port's
entry points and their sinks.

For every (entry point, axis) cell of the contract table
(``contracts.ENTRY_POINTS``) this pass proves three properties on the AST:

* **accepts** -- the entry's signature carries the axis (named parameter,
  or ``**kwargs`` for ``via="kwargs"`` cells);
* **validates** -- an unknown value raises loudly. Validation is found by
  a bounded recursion: a ``raise`` whose guard or message mentions the
  carrying name counts, and so does forwarding the value (keyword,
  positional, ``**kwargs``, or a ``kw.pop("axis")`` re-binding) into a
  function that validates it. Registry-dispatched entries instead declare
  ``sinks``: every listed sink must validate the axis itself, which is the
  multi-layer guarantee (dropping the check from one sink fails the
  build even though the entry still looks fine);
* **forwards** -- the value reaches a callee (skipped for terminal
  consumers, ``forward=False``).

Known limitation (documented, accepted): the raise heuristic proves "some
unknown values raise", not full membership validation — a check that
rejects one bad literal but swallows others passes. Dropping a check
entirely (the drift mode this pass is for) is always caught.

Finding codes::

    AX101  entry point does not accept a contracted axis
    AX102  axis accepted but no validation found
    AX103  axis accepted but never forwarded to a callee
    AX104  declared sink missing, unresolvable, or not validating
    AX105  contract row references a file/function that does not exist
    AX106  registered axis has no contract cell for an entry point
    AX107  an "n/a" waiver contradicts the signature (param exists)
    AX108  a decorator's static_argname looks like an undeclared engine
           axis (the port jits nothing: its table sweeps no module)
    AX109  validation raises a bare value (no message naming the
           allowed set)
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set, Tuple

from .findings import LintFinding, LintSeverity
from .model import (PortFunc, PortRepoModel, call_base_name_torch,
                    iter_functions_torch, kwargs_name_torch, mentions_torch,
                    param_names_torch, static_argnames_torch)

PASS_NAME = "axis-threading"

_MAX_DEPTH = 6


def _finding_torch(code: str, file: str, line: int, symbol: str, msg: str,
                   severity: str = LintSeverity.ERROR) -> LintFinding:
    return LintFinding(code=code, severity=severity, file=file, line=line,
                       symbol=symbol, message=msg, pass_name=PASS_NAME)


def _aliases_torch(fn: ast.AST, names: Set[str], axis: str) -> Set[str]:
    """Names re-binding the axis value inside ``fn`` (nested closures
    included — they capture the carried names lexically): plain renames of
    a carried name, ``target = kw.pop("axis", ...)`` / ``kw["axis"]``
    extractions from a carried kwargs dict, and the loop variable that
    takes a carried name's place in a literal table unpacked by a ``for``
    (``for axis, value, allowed in (("fill", fill, FILLS), ...)``: the
    port's ``check_axes`` validates its axes so; the reference's lint
    does not read it)."""
    out = set(names)
    for _ in range(3):  # fixpoint over chained renames (tiny bodies)
        grew = False
        for node in ast.walk(fn):
            if isinstance(node, ast.For):
                for tgt in _table_aliases_torch(node, out):
                    if tgt not in out:
                        out.add(tgt)
                        grew = True
                continue
            if not isinstance(node, ast.Assign):
                continue
            val = node.value
            hit = False
            if isinstance(val, ast.Name) and val.id in out:
                hit = True
            elif (isinstance(val, ast.Call)
                  and isinstance(val.func, ast.Attribute)
                  and val.func.attr in ("pop", "get")
                  and isinstance(val.func.value, ast.Name)
                  and val.func.value.id in out
                  and val.args
                  and isinstance(val.args[0], ast.Constant)
                  and val.args[0].value == axis):
                hit = True
            elif (isinstance(val, ast.Subscript)
                  and isinstance(val.value, ast.Name)
                  and val.value.id in out
                  and isinstance(val.slice, ast.Constant)
                  and val.slice.value == axis):
                hit = True
            if hit:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id not in out:
                        out.add(tgt.id)
                        grew = True
        if not grew:
            break
    return out


def _table_aliases_torch(loop: ast.For, names: Set[str]) -> List[str]:
    """The names a ``for`` over a literal table of tuples binds to a
    carried name: target ``i`` when row element ``i`` mentions one."""
    if not (isinstance(loop.target, ast.Tuple)
            and isinstance(loop.iter, (ast.Tuple, ast.List))):
        return []
    width = len(loop.target.elts)
    out = []
    for row in loop.iter.elts:
        if not isinstance(row, ast.Tuple) or len(row.elts) != width:
            continue
        for tgt, elt in zip(loop.target.elts, row.elts):
            if isinstance(tgt, ast.Name) and mentions_torch(elt, names):
                out.append(tgt.id)
    return out


def _validating_raises_torch(fn: ast.AST,
                             names: Set[str]) -> List[ast.Raise]:
    """Raise statements that reject a carried value: guarded by an ``if``
    whose test mentions a carried name, or whose message mentions one
    (nested closures included — they capture the names lexically)."""
    hits: List[ast.Raise] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.If) and mentions_torch(node.test, names):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Raise):
                    hits.append(sub)
        elif isinstance(node, ast.Raise) and node.exc is not None \
                and mentions_torch(node.exc, names):
            hits.append(node)
    return hits


def _bare_raises_torch(raises: Iterable[ast.Raise],
                       names: Set[str]) -> List[ast.Raise]:
    """Raises of the form ``raise ValueError(name)`` — loud in type but
    mute in message (no allowed-set text). The callee must be an exception
    class (a name ending in ``Error`` or ``Exception``): ``raise
    _unknown_mechanism(name)`` calls a helper that builds the message."""
    out = []
    for r in raises:
        exc = r.exc
        if (isinstance(exc, ast.Call) and len(exc.args) == 1
                and not exc.keywords
                and (call_base_name_torch(exc) or "").endswith(
                    ("Error", "Exception"))
                and isinstance(exc.args[0], ast.Name)
                and exc.args[0].id in names):
            out.append(r)
    return out


def _positional_formal_torch(callee: ast.AST, index: int) -> Optional[str]:
    """Formal parameter name receiving positional arg ``index`` (skipping
    ``self``/``cls`` on methods)."""
    formals = param_names_torch(callee)
    if formals and formals[0] in ("self", "cls"):
        formals = formals[1:]
    return formals[index] if index < len(formals) else None


def _entry_names_torch(callee: ast.AST, axis: str) -> Optional[Set[str]]:
    """Initial carried-name set when entering ``callee`` with the axis
    riding its kwargs or its like-named parameter."""
    if axis in param_names_torch(callee):
        return {axis}
    kw = kwargs_name_torch(callee)
    if kw is not None:
        return {kw}
    return None


class AxisGrounder:
    """Bounded-recursion validation search over the function index."""

    def __init__(self, model: PortRepoModel, axis: str):
        self.model = model
        self.axis = axis
        self.bare: List[Tuple[PortFunc, ast.Raise]] = []

    def grounds(self, entry: PortFunc, names: Set[str],
                depth: int = _MAX_DEPTH,
                seen: Optional[Set[Tuple[int, frozenset]]] = None) -> bool:
        if seen is None:
            seen = set()
        key = (id(entry.node), frozenset(names))
        if key in seen:
            return False
        seen.add(key)
        fn = entry.node
        aliased = _aliases_torch(fn, names, self.axis)
        raises = _validating_raises_torch(fn, aliased)
        if raises:
            for r in _bare_raises_torch(raises, aliased):
                self.bare.append((entry, r))
            return True
        if depth <= 0:
            return False
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
        for call in calls:
            base = call_base_name_torch(call)
            if base is None:
                continue
            targets = self.model.resolve_targets(base)
            if not targets:
                continue
            carried: List[Set[str]] = []
            for kw in call.keywords:
                if kw.arg is None:  # **expansion
                    if isinstance(kw.value, ast.Name) \
                            and kw.value.id in aliased:
                        for t in targets:
                            nm = _entry_names_torch(t.node, self.axis)
                            if nm and self.grounds(t, nm, depth - 1, seen):
                                return True
                elif mentions_torch(kw.value, aliased):
                    carried.append({kw.arg})
            for i, arg in enumerate(call.args):
                if isinstance(arg, ast.Starred):
                    continue
                if mentions_torch(arg, aliased):
                    for t in targets:
                        formal = _positional_formal_torch(t.node, i)
                        if formal and self.grounds(t, {formal},
                                                   depth - 1, seen):
                            return True
            for nm in carried:
                for t in targets:
                    if (nm & set(param_names_torch(t.node))
                            or kwargs_name_torch(t.node)):
                        tn = nm if nm & set(param_names_torch(t.node)) else \
                            {kwargs_name_torch(t.node)}
                        if self.grounds(t, tn, depth - 1, seen):
                            return True
        return False


def _forwards_torch(fn: ast.AST, names: Set[str], axis: str) -> bool:
    """True when a carried name reaches any call (keyword, positional or
    ``**`` expansion; nested closures included)."""
    aliased = _aliases_torch(fn, names, axis)
    for call in (n for n in ast.walk(fn) if isinstance(n, ast.Call)):
        for kw in call.keywords:
            if kw.arg is None:
                if isinstance(kw.value, ast.Name) and kw.value.id in aliased:
                    return True
            elif mentions_torch(kw.value, aliased):
                return True
        for arg in call.args:
            if isinstance(arg, ast.Starred):
                if isinstance(arg.value, ast.Name) \
                        and arg.value.id in aliased:
                    return True
            elif mentions_torch(arg, aliased):
                return True
    return False


def run_axis_threading_torch(model: PortRepoModel, axes: Tuple[str, ...],
                             entry_points: Dict,
                             static_modules: Tuple[str, ...] = (),
                             static_non_axes: frozenset = frozenset()
                             ) -> List[LintFinding]:
    """Check every contract cell; sweep static_argnames for new axes."""
    findings: List[LintFinding] = []

    for (file, qualname), row in entry_points.items():
        entry = model.find_function(file, qualname)
        if entry is None:
            findings.append(_finding_torch(
                "AX105", file, 1, qualname,
                f"contract references {qualname!r} in {file}, which does "
                f"not exist — update contracts.ENTRY_POINTS"))
            continue
        fn = entry.node
        formals = set(param_names_torch(fn))
        for axis in axes:
            spec = row.get(axis)
            symbol = f"{qualname}[{axis}]"
            if spec is None:
                findings.append(_finding_torch(
                    "AX106", file, fn.lineno, symbol,
                    f"axis {axis!r} has no contract cell for this entry "
                    f"point — declare how it threads or add an 'n/a' "
                    f"waiver in contracts.ENTRY_POINTS"))
                continue
            if isinstance(spec, str):  # explicit waiver
                if axis in formals:
                    findings.append(_finding_torch(
                        "AX107", file, fn.lineno, symbol,
                        f"contract waives axis {axis!r} as n/a but the "
                        f"signature has a parameter named {axis!r}"))
                continue
            param = spec.get("param", axis)
            via_kwargs = spec.get("via") == "kwargs"
            if via_kwargs:
                kwname = kwargs_name_torch(fn)
                if kwname is None:
                    findings.append(_finding_torch(
                        "AX101", file, fn.lineno, symbol,
                        f"axis {axis!r} is contracted to ride **kwargs but "
                        f"the entry point takes none"))
                    continue
                names = {kwname}
            else:
                if param not in formals:
                    findings.append(_finding_torch(
                        "AX101", file, fn.lineno, symbol,
                        f"entry point does not accept axis {axis!r} "
                        f"(expected parameter {param!r})"))
                    continue
                names = {param}

            grounder = AxisGrounder(model, axis)
            sinks = spec.get("sinks")
            if sinks:
                for sink in sinks:
                    targets = model.resolve_targets(sink)
                    if not targets:
                        findings.append(_finding_torch(
                            "AX104", file, fn.lineno, f"{symbol}->{sink}",
                            f"declared sink {sink!r} for axis {axis!r} "
                            f"does not exist"))
                        continue
                    for t in targets:
                        tn = _entry_names_torch(t.node, axis)
                        if tn is None:
                            findings.append(_finding_torch(
                                "AX104", t.module.rel, t.node.lineno,
                                f"{symbol}->{sink}",
                                f"sink {sink!r} accepts neither a "
                                f"{axis!r} parameter nor **kwargs"))
                        elif not grounder.grounds(t, tn):
                            findings.append(_finding_torch(
                                "AX104", t.module.rel, t.node.lineno,
                                f"{symbol}->{sink}",
                                f"sink {sink!r} does not validate axis "
                                f"{axis!r}: an unknown value passes "
                                f"silently"))
                if spec.get("require_direct") \
                        and not grounder.grounds(entry, names):
                    findings.append(_finding_torch(
                        "AX102", file, fn.lineno, symbol,
                        f"axis {axis!r} must also be validated in the "
                        f"entry itself (require_direct) but no check was "
                        f"found"))
            elif not grounder.grounds(entry, names):
                findings.append(_finding_torch(
                    "AX102", file, fn.lineno, symbol,
                    f"axis {axis!r} is accepted but never validated: an "
                    f"unknown value neither raises here nor in any "
                    f"function it is forwarded to"))
            for bentry, braise in grounder.bare:
                findings.append(_finding_torch(
                    "AX109", bentry.module.rel, braise.lineno,
                    f"{bentry.qualname}[{axis}]",
                    f"validation for axis {axis!r} raises the bare value "
                    f"— name the bad value and the allowed set in the "
                    f"message"))
            if spec.get("forward") and not _forwards_torch(fn, names, axis):
                findings.append(_finding_torch(
                    "AX103", file, fn.lineno, symbol,
                    f"axis {axis!r} is accepted but never forwarded to "
                    f"any callee"))

    # -- AX108: static_argnames sweep for undeclared axes ------------------
    for rel in static_modules:
        mod = model.modules.get(rel)
        if mod is None:
            findings.append(_finding_torch(
                "AX105", rel, 1, rel,
                "contracts.STATIC_ARGNAME_MODULES lists a missing module"))
            continue
        for qualname, fn in iter_functions_torch(mod.tree):
            for name in static_argnames_torch(fn):
                if name not in static_non_axes:
                    findings.append(_finding_torch(
                        "AX108", rel, fn.lineno, f"{qualname}[{name}]",
                        f"static argname {name!r} looks like a new engine "
                        f"axis nobody declared — add it to contracts.AXES "
                        f"(and a cell per entry point) or to "
                        f"STATIC_NON_AXES"))
    # de-duplicate (the same bare raise can be reached from several cells)
    uniq: Dict[Tuple[str, str, int], LintFinding] = {}
    for f in findings:
        uniq.setdefault((f.code, f.symbol, f.line), f)
    return list(uniq.values())
