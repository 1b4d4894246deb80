"""The port's AST model: parse each of its files once, index functions and
classes — the port's copy of ``repro/analysis/model.py``, scoped to the
port.

All passes share one :class:`PortRepoModel`. Its files are the port's own:
``src/repro_torch/``, the port's tests (``tests/test_torch_*.py`` and the
helpers they import) and ``chip_smoke.py``; never ``src/repro/``. So a
function of the reference with a port function's base name cannot ground
(or mask) a validation here, and the reference's lint, which parses the
whole of ``src/``, keeps its own scope (ROADMAP P2). The function index
maps *base names* to definitions, the right granularity for grounding
keyword-forwarding chains across modules without resolving imports: a
collision only makes the threading pass *stricter* (every candidate must
validate).
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

#: what ``PortRepoModel.load_port`` parses: repo-relative globs
PORT_SOURCES = ("src/repro_torch/**/*.py", "tests/test_torch_*.py",
                "tests/torch_gloo.py", "chip_smoke.py")


@dataclasses.dataclass
class PortFunc:
    """One function (or method) definition plus where it lives."""

    module: "PortModule"
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    qualname: str


@dataclasses.dataclass
class PortModule:
    """One parsed source file."""

    rel: str  # repo-relative posix path
    path: Path
    tree: ast.Module
    source: str


class PortRepoModel:
    """Parsed view of the port used by every pass."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.modules: Dict[str, PortModule] = {}
        # base function name -> all defs with that name (any module)
        self.functions: Dict[str, List[PortFunc]] = {}
        # class name -> (module, ClassDef)
        self.classes: Dict[str, Tuple[PortModule, ast.ClassDef]] = {}

    @classmethod
    def load_port(cls, root: Path,
                  patterns: Sequence[str] = PORT_SOURCES) -> "PortRepoModel":
        """Parse every file the repo-relative ``patterns`` match."""
        model = cls(root)
        seen = set()
        for pattern in patterns:
            for path in sorted(Path(root).glob(pattern)):
                if path.is_file() and path not in seen:
                    seen.add(path)
                    model.add_source(path)
        return model

    def add_source(self, path: Path) -> Optional[PortModule]:
        """Parse and index one file (skipped silently if unparseable paths
        are excluded upstream; a syntax error raises — the repo must parse).
        """
        rel = Path(path).resolve().relative_to(
            self.root.resolve()).as_posix()
        source = Path(path).read_text()
        tree = ast.parse(source, filename=rel)
        mod = PortModule(rel=rel, path=Path(path), tree=tree, source=source)
        self.modules[rel] = mod
        for qualname, node in iter_functions_torch(tree):
            self.functions.setdefault(
                node.name, []).append(PortFunc(mod, node, qualname))
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                self.classes.setdefault(node.name, (mod, node))
        return mod

    def find_function(self, rel: str, qualname: str) -> Optional[PortFunc]:
        """Find a specific function by file + dotted qualname."""
        mod = self.modules.get(rel)
        if mod is None:
            return None
        for qn, node in iter_functions_torch(mod.tree):
            if qn == qualname:
                return PortFunc(mod, node, qn)
        return None

    def resolve_targets(self, base_name: str) -> List[PortFunc]:
        """All plausible targets of a call to ``base_name``: functions with
        that name, plus ``__init__`` when the name is a known class."""
        targets = list(self.functions.get(base_name, ()))
        cls = self.classes.get(base_name)
        if cls is not None:
            mod, node = cls
            for item in node.body:
                if (isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and item.name == "__init__"):
                    targets.append(
                        PortFunc(mod, item, f"{node.name}.__init__"))
        return targets


# ---------------------------------------------------------------------------
# AST helpers shared by passes


def iter_functions_torch(tree: ast.AST) -> Iterator[Tuple[str, ast.AST]]:
    """Yield ``(qualname, FunctionDef)`` for every def, including nested
    ones and methods (qualnames are dotted through classes and parents)."""
    def walk_torch(node: ast.AST,
                   prefix: str) -> Iterator[Tuple[str, ast.AST]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qn = f"{prefix}{child.name}"
                yield qn, child
                yield from walk_torch(child, f"{qn}.")
            elif isinstance(child, ast.ClassDef):
                yield from walk_torch(child, f"{prefix}{child.name}.")
            else:
                yield from walk_torch(child, prefix)
    yield from walk_torch(tree, "")


def call_base_name_torch(call: ast.Call) -> Optional[str]:
    """Base name of a call target: ``f(...)`` -> ``f``; ``a.b.f(...)`` ->
    ``f``; anything else (subscripts, calls-of-calls) -> None."""
    func = call.func
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def dotted_name_torch(node: ast.AST) -> Optional[str]:
    """Render ``a.b.c`` attribute chains; None for non-name roots."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def mentions_torch(node: ast.AST, names: Set[str]) -> bool:
    """True iff any ``ast.Name`` inside ``node`` is in ``names``."""
    return any(isinstance(n, ast.Name) and n.id in names
               for n in ast.walk(node))


def param_names_torch(fn: ast.AST) -> List[str]:
    """Positional + keyword-only parameter names (no *args/**kw)."""
    a = fn.args
    return [p.arg for p in (*a.posonlyargs, *a.args, *a.kwonlyargs)]


def kwargs_name_torch(fn: ast.AST) -> Optional[str]:
    """Name of the ``**kwargs`` parameter, if the function takes one."""
    return fn.args.kwarg.arg if fn.args.kwarg is not None else None


def own_calls_torch(fn: ast.AST) -> Iterator[ast.Call]:
    """Calls in ``fn``'s body, excluding bodies of nested defs (those are
    separate scopes and are analysed on their own)."""
    def walk_torch(node: ast.AST) -> Iterator[ast.Call]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child,
                          (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
                continue
            if isinstance(child, ast.Call):
                yield child
            yield from walk_torch(child)
    yield from walk_torch(fn)


def own_nodes_torch(fn: ast.AST) -> Iterator[ast.AST]:
    """All nodes in ``fn``'s body excluding nested def/class bodies."""
    def walk_torch(node: ast.AST) -> Iterator[ast.AST]:
        for child in ast.iter_child_nodes(node):
            yield child
            if isinstance(child,
                          (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
                continue
            yield from walk_torch(child)
    yield from walk_torch(fn)


def static_argnames_torch(fn: ast.AST) -> List[str]:
    """``static_argnames`` constants from a decorator call, if any (the
    port jits nothing: kept so the axis pass's sweep reads a tree as the
    reference's does)."""
    names: List[str] = []
    for dec in getattr(fn, "decorator_list", ()):
        if not isinstance(dec, ast.Call):
            continue
        for kw in dec.keywords:
            if kw.arg != "static_argnames":
                continue
            val = kw.value
            elts = val.elts if isinstance(val, (ast.Tuple, ast.List)) \
                else [val]
            for e in elts:
                if isinstance(e, ast.Constant) and isinstance(e.value, str):
                    names.append(e.value)
    return names
