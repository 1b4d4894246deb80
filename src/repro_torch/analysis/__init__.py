"""The port's contract lint: AST static analysis of ``src/repro_torch``,
the port's copy of ``repro.analysis`` scoped to the port (it parses the
port's package, its tests and ``chip_smoke.py``, never ``src/repro/``).

Five passes:

* ``axis-threading`` -- every entry point of ``contracts.ENTRY_POINTS``
  accepts each engine axis, validates it loudly and forwards it (codes
  ``AX1xx``).
* ``host-sync`` -- the sweep and tick loops' reads of device values on
  the host: ``.item()``, conversions and predicates of tensors, copies to
  the host, synchronizes, and loops that call a syncing function (codes
  ``HS2xx``); it takes the place of the reference's ``jit-purity``.
* ``kernel-triples`` -- every ``kernels/*/`` package ships the
  ``kernel.py``/``ops.py``/``ref.py`` triple with matching signatures, a
  CUDA source in ``kernels/csrc/``, a CPU test file and a gpu-marked test
  that import it (codes ``KT3xx``).
* ``observability`` -- every ``SolveInfo``/``ChurnRecord`` field is
  populated or waived (codes ``OB4xx``).
* ``docstrings`` -- public-symbol docstring coverage of ``core`` and
  ``sched`` stays above the floor (codes ``DS5xx``).

Run ``python -m repro_torch.analysis --check``; add a finding that must
stay to ``src/repro_torch/analysis/baseline.json`` with a one-line reason.
"""
from __future__ import annotations

from .findings import LintFinding, LintSeverity, load_baseline_torch
from .model import PortRepoModel
from .runner import PASSES, run_analysis_torch

__all__ = [
    "LintFinding", "LintSeverity", "PortRepoModel", "PASSES",
    "run_analysis_torch", "load_baseline_torch",
]
