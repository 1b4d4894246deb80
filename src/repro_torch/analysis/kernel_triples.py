"""Kernel-triple conformance pass of the port's lint (codes ``KT3xx``) —
the port's copy of ``repro/analysis/kernel_triples.py``, run over
``src/repro_torch/kernels/``.

Every kernel package must ship the ``kernel.py`` (the Hopper kernel's
wrapper) / ``ops.py`` / ``ref.py`` (the plain PyTorch version) triple. The
public ops entry point and its plain twin are paired by name (suffixes
``_padded``/``_ref`` stripped, then equality / containment / a >=4-char
common prefix; a single-public-function module pairs by elimination) and
must agree on positional arity and positional parameter names —
keyword-only knobs are ops-side freedom. A Pallas compiler-params name
never belongs in the triple (the reference's shim rule, kept: the port
has no Pallas). Each package must be imported by its declared CPU test
file. Where the configuration names them, the package's CUDA source
``<csrc>/<package>.cu`` must exist, and the card's test file must import
the package and carry the ``gpu`` marker (a module ``pytestmark`` or a
test's decorator), so the card's lane runs the kernel.

Finding codes::

    KT301  triple file missing
    KT302  public ops function with no reference twin
    KT303  ops/ref positional arity mismatch
    KT304  ops/ref positional parameter names drift
    KT305  raw (non-shim) CompilerParams/TPUCompilerParams usage
    KT306  package not imported by its declared test file
    KT307  package has no CUDA source in the configured csrc directory
    KT308  package not imported by a gpu-marked test of the card's file
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .findings import LintFinding, LintSeverity
from .model import PortRepoModel, dotted_name_torch

PASS_NAME = "kernel-triples"


def _finding_torch(code: str, file: str, line: int, symbol: str,
                   msg: str) -> LintFinding:
    return LintFinding(code=code, severity=LintSeverity.ERROR, file=file,
                       line=line,
                   symbol=symbol, message=msg, pass_name=PASS_NAME)


def _public_functions_torch(tree: ast.Module) -> List[ast.FunctionDef]:
    return [n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
            and not n.name.startswith("_")]


def _positional_params_torch(fn: ast.AST) -> List[str]:
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args)]


def _norm_name_torch(name: str) -> str:
    for suffix in ("_padded", "_ref"):
        if name.endswith(suffix):
            name = name[: -len(suffix)]
    return name


def _pair_torch(ops_fn: ast.FunctionDef,
                refs: List[ast.FunctionDef]) -> Optional[ast.FunctionDef]:
    """Reference twin of an ops function, by normalized-name affinity."""
    o = _norm_name_torch(ops_fn.name)
    for r in refs:
        if _norm_name_torch(r.name) == o:
            return r
    for r in refs:
        rn = _norm_name_torch(r.name)
        if rn in o or o in rn:
            return r
    best, best_len = None, 3
    for r in refs:
        rn = _norm_name_torch(r.name)
        common = 0
        for a, b in zip(o, rn):
            if a != b:
                break
            common += 1
        if common > best_len:
            best, best_len = r, common
    if best is not None:
        return best
    if len(refs) == 1:
        return refs[0]
    return None


def _imports_package_torch(model: PortRepoModel, test_rel: str,
                           kdir_name: str, pkg: str) -> bool:
    mod = model.modules.get(test_rel)
    if mod is None:
        return False
    needle = f"{kdir_name}.{pkg}"
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom) and node.module \
                and needle in node.module:
            return True
        if isinstance(node, ast.Import):
            for a in node.names:
                if needle in a.name:
                    return True
    return False


def _gpu_marked_torch(model: PortRepoModel, test_rel: str) -> bool:
    """Whether the test file carries the ``gpu`` marker: ``pytestmark``
    naming ``mark.gpu``, or a decorator ``pytest.mark.gpu``."""
    mod = model.modules.get(test_rel)
    if mod is None:
        return False
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Attribute) and node.attr == "gpu" \
                and (dotted_name_torch(node) or "").endswith("mark.gpu"):
            return True
    return False


def run_kernel_triples_torch(model: PortRepoModel,
                             config: Dict) -> List[LintFinding]:
    """Check every kernels package against the triple contract (and, where
    ``config`` has ``csrc`` and ``gpu_test``, its CUDA source and the
    card's test)."""
    findings: List[LintFinding] = []
    kdir = Path(model.root) / config["dir"]
    # a kernel package is any subdirectory holding python files (the
    # packages are namespace-style: no __init__.py of their own)
    packages = sorted(p.name for p in kdir.iterdir()
                      if p.is_dir() and any(p.glob("*.py")))
    for pkg in packages:
        pkg_rel = f"{config['dir']}/{pkg}"
        triple: Dict[str, Optional[ast.Module]] = {}
        for fname in config["triple"]:
            rel = f"{pkg_rel}/{fname}"
            mod = model.modules.get(rel)
            if mod is None:
                findings.append(_finding_torch(
                    "KT301", pkg_rel, 1, f"{pkg}/{fname}",
                    f"kernel package {pkg!r} is missing {fname} — every "
                    f"package ships the kernel/ops/ref triple"))
            triple[fname] = mod

        # -- shim discipline on all present triple files -------------------
        for fname, mod in triple.items():
            if mod is None:
                continue
            for node in ast.walk(mod.tree):
                bad: Optional[Tuple[int, str]] = None
                if isinstance(node, ast.ImportFrom) and node.module \
                        and "pallas" in node.module:
                    for a in node.names:
                        if a.name in ("CompilerParams", "TPUCompilerParams"):
                            bad = (node.lineno, f"from {node.module} "
                                                f"import {a.name}")
                elif isinstance(node, ast.Attribute) \
                        and node.attr in ("CompilerParams",
                                          "TPUCompilerParams"):
                    dn = dotted_name_torch(node) or node.attr
                    if not dn.startswith("_compat."):
                        bad = (node.lineno, dn)
                if bad is not None:
                    findings.append(_finding_torch(
                        "KT305", mod.rel, bad[0], f"{pkg}/{fname}",
                        f"raw compiler-params name ({bad[1]}) — use the "
                        f"_compat.CompilerParams shim (absorbs the "
                        f"TPUCompilerParams rename)"))

        # -- ops/ref signature conformance ----------------------------------
        ops_mod, ref_mod = triple.get("ops.py"), triple.get("ref.py")
        if ops_mod is not None and ref_mod is not None:
            refs = _public_functions_torch(ref_mod.tree)
            for ops_fn in _public_functions_torch(ops_mod.tree):
                twin = _pair_torch(ops_fn, refs)
                symbol = f"{pkg}.{ops_fn.name}"
                if twin is None:
                    findings.append(_finding_torch(
                        "KT302", ops_mod.rel, ops_fn.lineno, symbol,
                        f"public ops function {ops_fn.name!r} has no "
                        f"reference twin in ref.py"))
                    continue
                op_pos = _positional_params_torch(ops_fn)
                rf_pos = _positional_params_torch(twin)
                if len(op_pos) != len(rf_pos):
                    findings.append(_finding_torch(
                        "KT303", ops_mod.rel, ops_fn.lineno, symbol,
                        f"positional arity differs from {twin.name!r}: "
                        f"ops takes {len(op_pos)} ({', '.join(op_pos)}), "
                        f"ref takes {len(rf_pos)} ({', '.join(rf_pos)})"))
                elif op_pos != rf_pos:
                    findings.append(_finding_torch(
                        "KT304", ops_mod.rel, ops_fn.lineno, symbol,
                        f"positional parameter names drift from "
                        f"{twin.name!r}: ops ({', '.join(op_pos)}) vs "
                        f"ref ({', '.join(rf_pos)})"))

        # -- test coverage --------------------------------------------------
        test_rel = config["tests"].get(pkg, config["default_test"])
        if not _imports_package_torch(model, test_rel, kdir.name, pkg):
            findings.append(_finding_torch(
                "KT306", pkg_rel, 1, pkg,
                f"kernel package {pkg!r} is not imported by its declared "
                f"test file {test_rel} — the CPU lane never runs it"))
        csrc = config.get("csrc")
        if csrc and not (Path(model.root) / csrc / f"{pkg}.cu").is_file():
            findings.append(_finding_torch(
                "KT307", pkg_rel, 1, pkg,
                f"kernel package {pkg!r} has no CUDA source {csrc}/{pkg}.cu"
                f" — every package's kernel is written for the card"))
        gpu_test = config.get("gpu_test")
        if gpu_test and not (
                _gpu_marked_torch(model, gpu_test)
                and _imports_package_torch(model, gpu_test, kdir.name, pkg)):
            findings.append(_finding_torch(
                "KT308", pkg_rel, 1, pkg,
                f"kernel package {pkg!r} is not imported by a gpu-marked "
                f"test file {gpu_test} — the card's lane never runs its "
                f"kernel"))
    return findings
