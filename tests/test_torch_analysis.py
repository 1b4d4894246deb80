"""The port's contract lint (``repro_torch.analysis``) against the
reference's (``repro.analysis``), and on the port itself.

Parity: each pass the port copied (axis-threading, kernel-triples,
observability, docstrings) gives the reference's findings — code, file,
line and symbol — on the synthetic trees and miniature tables of
``tests/test_analysis.py``. The copy's two repairs are pinned apart: it
reads a validation table unpacked by a ``for`` (the port's
``check_axes``), and it takes ``raise helper(name)`` for a helper that
builds the message. ``host-sync``, which takes the place of the
reference's jit-purity pass, gets fixtures of its own: each ``HS2xx``
code flagged, pure torch clean. The gate: the port's lint has no gate
failure, a reason on every baseline entry and no stale one; it exits
non-zero on a copy of the port with one axis validation dropped; its CLI
imports neither jax nor ``repro``."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro.analysis import axis_threading as ref_axes
from repro.analysis import docstrings as ref_docstrings
from repro.analysis import kernel_triples as ref_triples
from repro.analysis import observability as ref_observability
from repro.analysis.model import RepoModel
from repro_torch.analysis import axis_threading, docstrings, host_sync, \
    kernel_triples, observability
from repro_torch.analysis.findings import load_baseline_torch
from repro_torch.analysis.model import PortRepoModel
from repro_torch.analysis.runner import run_analysis_torch

REPO_ROOT = Path(__file__).resolve().parents[1]


def _models(tmp_path: Path, files: dict):
    """The reference's and the port's model over the same fixture files."""
    ref, port = RepoModel(tmp_path), PortRepoModel(tmp_path)
    for rel, source in files.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(source))
        ref.add_file(path)
        port.add_source(path)
    return ref, port


def _keys(findings):
    return sorted((f.code, f.file, f.line, f.symbol) for f in findings)


# -- parity on tests/test_analysis.py's trees ---------------------------------

AXIS_CASES = {
    "unvalidated": ({"src/mod.py": """\
        def solve(problem, fill="event"):
            return problem, fill
    """}, {("src/mod.py", "solve"): {"fill": dict(param="fill")}},
        ("fill",), {}),
    "validated_and_forwarded": ({"src/mod.py": """\
        def _core(problem, fill):
            return problem

        def solve(problem, fill="event"):
            if fill not in ("event", "bisect"):
                raise ValueError(
                    f"fill must be 'event' or 'bisect': {fill!r}")
            return _core(problem, fill=fill)
    """}, {("src/mod.py", "solve"): {"fill": dict(param="fill",
                                                  forward=True)}},
        ("fill",), {}),
    "grounded_through_callee": ({"src/mod.py": """\
        def _core(problem, fill):
            if fill not in ("event", "bisect"):
                raise ValueError(f"fill: {fill!r}")
            return problem

        def solve(problem, fill="event"):
            return _core(problem, fill)
    """}, {("src/mod.py", "solve"): {"fill": dict(param="fill")}},
        ("fill",), {}),
    "bare_value_raise": ({"src/mod.py": """\
        def solve(problem, fill="event"):
            if fill not in ("event", "bisect"):
                raise ValueError(fill)
            return problem
    """}, {("src/mod.py", "solve"): {"fill": dict(param="fill")}},
        ("fill",), {}),
    "missing_param_and_cell": ({"src/mod.py": """\
        def solve(problem):
            return problem
    """}, {("src/mod.py", "solve"): {"fill": dict(param="fill")}},
        ("fill", "layout"), {}),
    "sink_must_validate": ({"src/mod.py": """\
        REGISTRY = {}

        def _alloc(problem, fill="event"):
            return problem

        def solve(problem, mech, fill="event"):
            return REGISTRY[mech](problem, fill=fill)
    """}, {("src/mod.py", "solve"): {"fill": dict(param="fill",
                                                  sinks=("_alloc",))}},
        ("fill",), {}),
    "undeclared_static_argname": ({"src/mod.py": """\
        import functools
        import jax

        @functools.partial(jax.jit, static_argnames=("fill", "sparsity"))
        def solve(problem, fill="event", sparsity="auto"):
            if fill not in ("event", "bisect"):
                raise ValueError(f"fill must be event/bisect: {fill!r}")
            return problem
    """}, {("src/mod.py", "solve"): {"fill": dict(param="fill")}},
        ("fill",), dict(static_modules=("src/mod.py",),
                        static_non_axes=frozenset({"fill"}))),
}


@pytest.mark.parametrize("case", sorted(AXIS_CASES))
def test_axis_threading_matches_reference(tmp_path, case):
    files, entries, axes, extra = AXIS_CASES[case]
    ref, port = _models(tmp_path, files)
    want = ref_axes.run(ref, axes, entries, **extra)
    got = axis_threading.run_axis_threading_torch(port, axes, entries,
                                                  **extra)
    assert _keys(got) == _keys(want)
    assert [f.message for f in sorted(got, key=lambda f: f.code)] == \
        [f.message for f in sorted(want, key=lambda f: f.code)]


def _triples_config(tests=None):
    return dict(dir="src/k", triple=("kernel.py", "ops.py", "ref.py"),
                default_test="tests/test_k.py", tests=tests or {})


TRIPLE_CASES = {
    "missing_file_raw_params_and_no_test": {
        "src/k/badpkg/kernel.py": """\
            from jax.experimental.pallas import CompilerParams

            def _kernel():
                return CompilerParams
        """,
        "src/k/badpkg/ops.py": """\
            def op(a, b):
                return a + b
        """,
        "tests/test_k.py": """\
            import os
        """,
    },
    "ops_function_without_twin": {
        "src/k/twinless/kernel.py": "def _k():\n    return 0\n",
        "src/k/twinless/ops.py": """\
            def zzz_op(a):
                return a
        """,
        "src/k/twinless/ref.py": """\
            def alpha(a):
                return a

            def beta(a):
                return a
        """,
        "tests/test_k.py": "import k.twinless.ops\n",
    },
    "signature_drift": {
        "src/k/driftpkg/kernel.py": "def _k():\n    return 0\n",
        "src/k/driftpkg/ops.py": """\
            def run_op(q, k_cache):
                return q
        """,
        "src/k/driftpkg/ref.py": """\
            def run_op_ref(q, k):
                return q
        """,
        "tests/test_k.py": "import k.driftpkg.ops\n",
    },
    "conforming_package": {
        "src/k/goodpkg/kernel.py": """\
            from repro.kernels import _compat

            def _kernel():
                return _compat.CompilerParams(dimension_semantics=())
        """,
        "src/k/goodpkg/ops.py": """\
            def run_op(q, k, *, block_q=128, interpret=False):
                return q
        """,
        "src/k/goodpkg/ref.py": """\
            def run_op_ref(q, k):
                return q
        """,
        "tests/test_k.py": "import k.goodpkg.ops\n",
    },
}


@pytest.mark.parametrize("case", sorted(TRIPLE_CASES))
def test_kernel_triples_match_reference(tmp_path, case):
    ref, port = _models(tmp_path, TRIPLE_CASES[case])
    want = ref_triples.run(ref, _triples_config())
    got = kernel_triples.run_kernel_triples_torch(port, _triples_config())
    assert _keys(got) == _keys(want)
    assert _keys(want) or case == "conforming_package"


def test_kernel_triples_want_a_cuda_source_and_a_gpu_test(tmp_path):
    # the port's two checks, where the configuration names them
    files = dict(TRIPLE_CASES["conforming_package"])
    files["tests/test_gpu.py"] = "import k.goodpkg.kernel\n"
    _, port = _models(tmp_path, files)
    cfg = dict(_triples_config(), csrc="src/k/csrc",
               gpu_test="tests/test_gpu.py")
    found = kernel_triples.run_kernel_triples_torch(port, cfg)
    assert [f.code for f in sorted(found, key=lambda f: f.code)] == [
        "KT307", "KT308"]
    (tmp_path / "src/k/csrc").mkdir()
    (tmp_path / "src/k/csrc/goodpkg.cu").write_text("// kernel\n")
    marked = tmp_path / "tests/test_gpu.py"
    marked.write_text("import pytest\nimport k.goodpkg.kernel\n\n"
                      "pytestmark = pytest.mark.gpu\n")
    port.add_source(marked)
    assert kernel_triples.run_kernel_triples_torch(port, cfg) == []


OBS_FILES = {
    "src/obs/info.py": """\
        import dataclasses

        @dataclasses.dataclass
        class Info:
            rounds: int
            extra: str = ""
            dead: int = 0

        def make():
            return Info(1, extra="x")
    """,
    "src/obs/other.py": """\
        from .info import Info

        def make():
            return Info(2)
    """,
}
OBS_WRITTEN = dict(OBS_FILES, **{"src/obs/other.py": """\
    from .info import Info

    def make():
        info = Info(2)
        info.dead = 1
        return info
"""})


def _obs_spec(waivers=None):
    return {"Info": dict(module="src/obs/info.py",
                         writer_groups={"numpy": ("src/obs/info.py",),
                                        "jax": ("src/obs/other.py",)},
                         waivers=waivers or {})}


@pytest.mark.parametrize("files,waivers", [
    (OBS_FILES, None),
    (OBS_FILES, {("nope", "numpy"): "field was removed"}),
    (OBS_WRITTEN, {("extra", "jax"): "jax path has no extra telemetry",
                   ("dead", "numpy"): "written on the jax side only"}),
], ids=["dead_and_uncovered", "stale_waiver", "waived_and_written"])
def test_observability_matches_reference(tmp_path, files, waivers):
    ref, port = _models(tmp_path, files)
    want = ref_observability.run(ref, _obs_spec(waivers))
    got = observability.run_observability_torch(port, _obs_spec(waivers))
    assert _keys(got) == _keys(want)


@pytest.mark.parametrize("source", ['''\
    """Module docstring."""

    def documented():
        """Doc."""

    def naked():
        return 0
''', '''\
    """Module docstring."""

    def documented():
        """Doc."""
'''], ids=["below_floor", "full_coverage"])
def test_docstrings_match_reference(tmp_path, source):
    ref, port = _models(tmp_path, {"src/p/mod.py": source})
    cfg = dict(packages=("src/p",), min_percent=95.0)
    want = ref_docstrings.run(ref, cfg)
    assert _keys(docstrings.run_docstrings_torch(port, cfg)) == _keys(want)


# -- the copy's repairs -------------------------------------------------------

def test_axis_validated_in_a_loop_table(tmp_path):
    # the port's check_axes validates its axes by unpacking a literal
    # table; the copy reads it, the reference's pass does not
    ref, port = _models(tmp_path, {"src/mod.py": """\
        FILLS = ("event", "bisect")

        def check(*, fill="event"):
            for axis, value, allowed in (("fill", fill, FILLS),):
                if value not in allowed:
                    raise ValueError(f"{axis} must be one of {allowed}")

        def solve(problem, fill="event"):
            check(fill=fill)
            return problem
    """})
    entries = {("src/mod.py", "solve"): {"fill": dict(param="fill")}}
    assert [f.code for f in ref_axes.run(ref, ("fill",), entries)] == \
        ["AX102"]
    assert axis_threading.run_axis_threading_torch(port, ("fill",),
                                                   entries) == []


def test_raise_of_a_message_helper_is_not_bare(tmp_path):
    ref, port = _models(tmp_path, {"src/mod.py": """\
        def _unknown(name):
            return ValueError(f"unknown {name!r}; known: a, b")

        def solve(problem, fill="event"):
            if fill not in ("a", "b"):
                raise _unknown(fill)
            return problem
    """})
    entries = {("src/mod.py", "solve"): {"fill": dict(param="fill")}}
    assert [f.code for f in ref_axes.run(ref, ("fill",), entries)] == \
        ["AX109"]
    assert axis_threading.run_axis_threading_torch(port, ("fill",),
                                                   entries) == []


# -- host-sync fixtures -------------------------------------------------------

def _host_sync(tmp_path, source):
    _, port = _models(tmp_path, {"src/x/mod.py": source})
    return sorted(host_sync.run_host_sync_torch(
        port, ("src/x",), (r"^_solve_core",), frozenset({"_check"})),
        key=lambda f: (f.line, f.code))


def test_host_sync_flags_each_read(tmp_path):
    found = _host_sync(tmp_path, """\
        import torch

        def _solve_core(x, limit):
            n = x.sum().item()
            while bool(x.max() > limit):
                x = x / 2
            if x.any():
                x = x + 1
            order = x.argsort().tolist()
            torch.cuda.synchronize()
            return x, n, order
    """)
    assert [(f.code, f.line) for f in found] == [
        ("HS201", 4), ("HS202", 5), ("HS203", 7), ("HS204", 9),
        ("HS205", 10)]
    assert all(f.symbol == "_solve_core" for f in found)


def test_host_sync_flags_a_loop_over_a_syncing_call(tmp_path):
    # the scope closes over called helpers, a local bound to a call
    # reaches the functions its callee names, and a loop that calls a
    # syncing function once an iteration is one more wait an iteration
    found = _host_sync(tmp_path, """\
        import torch

        def _fill(x):
            while bool((x > 0).any()):
                x = x - 1
            return x

        def _pick(kind):
            return _fill if kind else _fill

        def _solve_core(x, servers, kind):
            fill_fn = _pick(kind)
            for i in servers:
                x[:, i] = fill_fn(x[:, i])
            return x
    """)
    assert [(f.code, f.line, f.symbol) for f in found] == [
        ("HS202", 4, "_fill"), ("HS206", 14, "_solve_core")]


def test_host_sync_leaves_pure_torch_clean(tmp_path):
    assert _host_sync(tmp_path, """\
        import torch

        def _check(x):
            if bool(x.any()):
                raise ValueError("gated: validates a plain argument")

        def _solve_core(x, limit, rounds: int):
            _check(x)
            for _ in range(int(rounds)):
                x = torch.where(x > limit, x / 2, x)
            return x, int(x.shape[0]), len(x)
    """) == []


# -- the gate on the port -----------------------------------------------------

def test_port_lint_is_clean():
    report = run_analysis_torch(REPO_ROOT)
    live = [f for f in report.findings
            if not f.baselined and f.severity == "error"]
    assert live == [], "\n" + report.render_report()
    assert report.gate_failure_count == 0
    assert report.stale_baseline == []
    # it parsed the port, nothing of the reference
    assert set(report.passes) == {"axis-threading", "host-sync",
                                  "kernel-triples", "observability",
                                  "docstrings"}
    # the host reads the sweep and tick loops make on purpose are waived
    waived = {(f.code, f.symbol) for f in report.findings if f.baselined}
    assert {("HS202", "_fill_one_server_rdm_bisect"),
            ("HS202", "_plain_rounds"),
            ("HS206", "_tick_torch"),
            ("HS206", "_tick_torch_bucketed")} <= waived


def test_baseline_entries_have_reasons():
    path = REPO_ROOT / "src" / "repro_torch" / "analysis" / "baseline.json"
    entries = json.loads(path.read_text())
    assert entries and all(e["reason"].strip() for e in entries)
    assert len(load_baseline_torch(path)) == len(entries)
    assert all(e["file"].startswith("src/repro_torch/") for e in entries)


def _port_copy(dest: Path):
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc")
    shutil.copytree(REPO_ROOT / "src" / "repro_torch",
                    dest / "src" / "repro_torch", ignore=ignore)
    (dest / "tests").mkdir()
    for path in (REPO_ROOT / "tests").glob("test_torch_*.py"):
        shutil.copy(path, dest / "tests" / path.name)
    shutil.copy(REPO_ROOT / "chip_smoke.py", dest / "chip_smoke.py")


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))
    code = ("import runpy, sys\n"
            f"sys.argv = ['repro_torch.analysis'] + {list(args)!r}\n"
            "try:\n"
            "    runpy.run_module('repro_torch.analysis', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print('IMPORTED', bad)\n"
            "sys.exit(rc)\n")
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)


def test_check_passes_and_imports_no_jax(tmp_path):
    out = tmp_path / "lint.json"
    proc = _cli("--check", "--json", str(out))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED []" in proc.stdout
    payload = json.loads(out.read_text())
    assert payload["summary"]["gate_failures"] == 0


def test_dropped_validation_fails_check(tmp_path):
    _port_copy(tmp_path)
    # the tick layer's check of its mode, fill, layout and accel
    dyn = tmp_path / "src/repro_torch/core/dynamic.py"
    text = dyn.read_text()
    guard = ("        check_axes(mode=mode, fill=fill, layout=layout, "
             "accel=accel)\n")
    assert text.count(guard) == 1
    dyn.write_text(text.replace(guard, ""))
    proc = _cli("--check", "--root", str(tmp_path))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "AX102" in proc.stdout
    assert "DistributedPSDSF.__init__[fill]" in proc.stdout
    assert "DistributedPSDSF.__init__[accel]" in proc.stdout
