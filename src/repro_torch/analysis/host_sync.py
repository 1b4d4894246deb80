"""Host-sync pass of the port's lint (codes ``HS2xx``): the port's
replacement of the reference's jit-purity pass, which has no torch
meaning (nothing is traced; every op runs as it is called).

What matters on the card instead is where the host waits for the device.
Roots are the sweep and tick loops (``contracts.HOST_SYNC``: the
reference's traced roots under the port's names, and the tick bodies of
``core/dynamic.py``); the scope is their call closure over the scanned
modules, minus the host gates (validators of plain arguments), resolved
as the reference's jit-purity pass resolves it. Inside the scope the pass
flags each read of a device value on the host::

    HS201  .item()
    HS202  bool()/float()/int() of a tensor expression (anything but a
           constant, a bare name, len() or a shape)
    HS203  Python if/while on a tensor predicate (a reduction method or a
           torch call in the test, with no explicit conversion)
    HS204  .cpu()/.tolist()/.numpy()
    HS205  torch.cuda.synchronize()
    HS206  a loop calls, once an iteration, a function of the scope that
           syncs (one with a finding above, directly or through its
           callees; a local bound to a call resolves to the functions that
           call's callee names, as ``fill_fn = _server_fill(mode, fill)``)

A finding sitting outside the loops' scope (an end-of-solve copy back to
numpy) is not looked for. Deliberate reads are waived in the baseline
with a reason; the bits a loop computes decide what a rewrite may do.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .findings import LintFinding, LintSeverity
from .model import (PortRepoModel, call_base_name_torch, dotted_name_torch,
                    iter_functions_torch, own_calls_torch, own_nodes_torch)

PASS_NAME = "host-sync"

_CONVERSIONS = {"bool", "float", "int"}
_HOST_COPIES = {"cpu", "tolist", "numpy"}
_REDUCTIONS = {"any", "all", "max", "min", "sum", "amax", "amin", "norm",
               "equal", "allclose"}
_SHAPE_ATTRS = {"shape", "ndim", "size"}
_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)


def _finding_torch(code: str, file: str, line: int, symbol: str,
                   msg: str) -> LintFinding:
    return LintFinding(code=code, severity=LintSeverity.ERROR, file=file,
                       line=line, symbol=symbol, message=msg,
                       pass_name=PASS_NAME)


def _scope_torch(model: PortRepoModel, scan_rels: List[str],
                 root_patterns: Tuple[str, ...],
                 gates: frozenset) -> Dict[int, Tuple]:
    """id(node) -> (module, qualname, node, enclosing defs) for the roots,
    their nested closures and their closure within ``scan_rels`` over the
    functions they call or name (a function a scoped one returns or
    passes on is called by someone in the scope; same module first,
    another module's name only when unambiguous)."""
    pats = [re.compile(p) for p in root_patterns]
    scope: Dict[int, Tuple] = {}
    work: List[Tuple] = []

    def add_scope_torch(mod, qualname, fn, parents):
        if id(fn) in scope or fn.name in gates:
            return
        scope[id(fn)] = (mod, qualname, fn, parents)
        work.append((mod, qualname, fn, parents))
        for node in _direct_defs_torch(fn):
            add_scope_torch(mod, f"{qualname}.{node.name}", node,
                            parents + (fn,))

    scan_set = set(scan_rels)
    for rel in scan_rels:
        mod = model.modules[rel]
        for qualname, fn in iter_functions_torch(mod.tree):
            if "." not in qualname and any(p.search(fn.name) for p in pats):
                add_scope_torch(mod, qualname, fn, ())
    while work:
        mod, qualname, fn, parents = work.pop()
        named = [call_base_name_torch(c) for c in own_calls_torch(fn)]
        named += [n.id for n in own_nodes_torch(fn)
                  if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)]
        for base in dict.fromkeys(named):
            if base is None or base in gates:
                continue
            if _lexical_torch(base, fn, parents) is not None:
                continue        # a nested closure: added with its parent
            cands = [t for t in model.functions.get(base, ())
                     if t.module.rel in scan_set and "." not in t.qualname]
            same = [t for t in cands if t.module is mod]
            for t in same or (cands if len(cands) == 1 else ()):
                add_scope_torch(t.module, t.qualname, t.node, ())
    return scope


def _direct_defs_torch(fn: ast.AST) -> List[ast.AST]:
    """The defs nested directly in ``fn``'s body (not inside another
    nested def)."""
    out = []
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, _DEFS):
            out.append(node)
        elif not isinstance(node, ast.ClassDef):
            stack.extend(ast.iter_child_nodes(node))
    return out


def _lexical_torch(name: str, fn: ast.AST,
                   parents: Tuple[ast.AST, ...]) -> Optional[ast.AST]:
    """The def ``name`` refers to inside ``fn`` by lexical scope: a def
    nested in ``fn`` or in an enclosing def, innermost first."""
    for owner in (fn,) + tuple(reversed(parents)):
        for node in _direct_defs_torch(owner):
            if node.name == name:
                return node
    return None


def _hostsafe_torch(arg: ast.AST) -> bool:
    """A conversion's argument that is plainly a host value: a constant,
    a bare name, ``len(...)`` or a shape (``x.shape[0]``, ``x.ndim``)."""
    if isinstance(arg, (ast.Constant, ast.Name)):
        return True
    if isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name) \
            and arg.func.id == "len":
        return True
    node = arg.value if isinstance(arg, ast.Subscript) else arg
    return isinstance(node, ast.Attribute) and node.attr in _SHAPE_ATTRS


def _tensor_predicate_torch(test: ast.AST) -> bool:
    """The test reads a tensor without an explicit conversion: a reduction
    method or a ``torch.*`` call in it, and no bool()/float()/int()."""
    calls = [n for n in ast.walk(test) if isinstance(n, ast.Call)]
    if any(isinstance(c.func, ast.Name) and c.func.id in _CONVERSIONS
           for c in calls):
        return False
    for c in calls:
        if isinstance(c.func, ast.Attribute):
            if c.func.attr in _REDUCTIONS:
                return True
            root = (dotted_name_torch(c.func) or "").split(".")[0]
            if root == "torch":
                return True
    return False


def _direct_findings_torch(mod, qualname, fn) -> List[LintFinding]:
    out: List[LintFinding] = []
    for node in own_nodes_torch(fn):
        if isinstance(node, ast.Call):
            func = node.func
            dn = dotted_name_torch(func) or ""
            if isinstance(func, ast.Attribute) and func.attr == "item":
                out.append(_finding_torch(
                    "HS201", mod.rel, node.lineno, qualname,
                    ".item() reads a device value on the host (the host "
                    "waits for the device)"))
            elif isinstance(func, ast.Name) and func.id in _CONVERSIONS \
                    and node.args and not _hostsafe_torch(node.args[0]):
                out.append(_finding_torch(
                    "HS202", mod.rel, node.lineno, qualname,
                    f"{func.id}() of a tensor expression reads it on the "
                    f"host (the host waits for the device)"))
            elif isinstance(func, ast.Attribute) \
                    and func.attr in _HOST_COPIES:
                out.append(_finding_torch(
                    "HS204", mod.rel, node.lineno, qualname,
                    f".{func.attr}() copies a tensor to the host inside the "
                    f"loop's scope"))
            elif dn.endswith("cuda.synchronize"):
                out.append(_finding_torch(
                    "HS205", mod.rel, node.lineno, qualname,
                    "torch.cuda.synchronize() stalls the host inside the "
                    "loop's scope"))
        elif isinstance(node, (ast.If, ast.While)) \
                and _tensor_predicate_torch(node.test):
            kind = "while" if isinstance(node, ast.While) else "if"
            out.append(_finding_torch(
                "HS203", mod.rel, node.lineno, qualname,
                f"Python `{kind}` on a tensor predicate reads it on the "
                f"host — keep the decision on the device (torch.where, a "
                f"fixed bound)"))
    return out


def _loop_calls_torch(fn: ast.AST) -> List[ast.Call]:
    """Calls inside ``fn``'s for/while loops (not in nested defs)."""
    out = []
    for node in own_nodes_torch(fn):
        if isinstance(node, (ast.For, ast.While)):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Call) and sub not in out:
                    out.append(sub)
    nested = {id(n) for d in _direct_defs_torch(fn) for n in ast.walk(d)}
    return [c for c in out if id(c) not in nested]


def _targets_torch(call: ast.Call, fn: ast.AST, parents, module,
                   model: PortRepoModel, scan_set: Set[str]) -> List[ast.AST]:
    """The defs a call may reach: by lexical scope, in the module, or
    unambiguously across the scanned modules; a local bound by ``name =
    g(...)`` reaches every module function ``g`` names."""
    base = call_base_name_torch(call)
    if base is None:
        return []
    node = _lexical_torch(base, fn, parents)
    if node is not None:
        return [node]
    if isinstance(call.func, ast.Name):
        for owner in (fn,) + tuple(parents):
            for sub in ast.walk(owner):
                if isinstance(sub, ast.Assign) and isinstance(
                        sub.value, ast.Call) and any(
                        isinstance(t, ast.Name) and t.id == base
                        for t in sub.targets):
                    maker = _module_defs_torch(
                        call_base_name_torch(sub.value), module, model,
                        scan_set)
                    named = []
                    for m in maker:
                        for n in ast.walk(m):
                            if isinstance(n, ast.Name):
                                named += _module_defs_torch(
                                    n.id, module, model, scan_set)
                    if named:
                        return named
    return _module_defs_torch(base, module, model, scan_set)


def _module_defs_torch(name, module, model: PortRepoModel,
                       scan_set: Set[str]) -> List[ast.AST]:
    if name is None:
        return []
    cands = [t for t in model.functions.get(name, ())
             if t.module.rel in scan_set and "." not in t.qualname]
    same = [t.node for t in cands if t.module is module]
    return same or ([cands[0].node] if len(cands) == 1 else [])


def run_host_sync_torch(model: PortRepoModel, scan_dirs: Tuple[str, ...],
                        root_patterns: Tuple[str, ...],
                        host_gates: frozenset) -> List[LintFinding]:
    """Scan the sweep and tick loops' scope under ``scan_dirs``."""
    scan_rels = [rel for rel in model.modules
                 if any(rel.startswith(d.rstrip("/") + "/") or rel == d
                        for d in scan_dirs)]
    scan_set = set(scan_rels)
    scope = _scope_torch(model, scan_rels, root_patterns, host_gates)
    findings: List[LintFinding] = []
    syncing: Set[int] = set()
    for key, (mod, qualname, fn, _) in scope.items():
        direct = _direct_findings_torch(mod, qualname, fn)
        findings += direct
        if direct:
            syncing.add(id(fn))
    # a function syncs when a callee does: to a fixed point, then each
    # loop's call of a syncing function is one wait an iteration
    calls = {key: [(c, _targets_torch(c, fn, parents, mod, model,
                                      scan_set))
                   for c in ast.walk(fn) if isinstance(c, ast.Call)]
             for key, (mod, _, fn, parents) in scope.items()}
    grew = True
    while grew:
        grew = False
        for key, pairs in calls.items():
            if key not in syncing and any(id(t) in syncing
                                          for _, ts in pairs for t in ts):
                syncing.add(key)
                grew = True
    for key, (mod, qualname, fn, parents) in scope.items():
        for call in _loop_calls_torch(fn):
            targets = _targets_torch(call, fn, parents, mod, model, scan_set)
            hit = [t for t in targets if id(t) in syncing]
            if hit:
                findings.append(_finding_torch(
                    "HS206", mod.rel, call.lineno, qualname,
                    f"a loop calls {call_base_name_torch(call)}() once an "
                    f"iteration, which reads the device on the host "
                    f"({', '.join(sorted({t.name for t in hit}))})"))
    return findings
