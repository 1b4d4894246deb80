"""One-call entry of the port: ``solve(problem, mechanism, ...)``.

The counterpart of ``repro.core.engine.solve`` with ``backend="jax"`` for
the PS-DSF mechanisms, i.e. of ``_solve_psdsf_via_jax``: it solves on the
device (``cuda`` unless the caller passes ``device="cpu"``) and returns the
same ``(Allocation, SolveInfo)`` pair with every field the reference fills.
A problem's float64 arrays go through as float64 (torch has no x64 switch
to turn off), so an ``engine.solve`` is a float64 solve; call
``psdsf_torch.psdsf_solve_torch`` with float32 arrays for a float32 one.

Not ported yet, and raising ``NotImplementedError`` with the ROADMAP item:
the baseline mechanisms, the numpy backend, ``placement="headroom"``,
``layout="bucketed"``/``"auto"`` and ``accel="anderson"``. The layout
defaults to ``"dense"`` here (the reference's ``"auto"`` resolves between
dense and the bucketed path this slice does not have).
"""
from __future__ import annotations

from typing import Tuple

from ..device import DeviceLike
from .gamma import gamma_matrix
from .psdsf_torch import check_axes, psdsf_solve_torch
from .solveinfo import SolveInfo, fill_iter_budget, stranded_fraction
from .types import Allocation, AllocationProblem

PSDSF_MECHANISMS = ("psdsf-rdm", "psdsf-tdm")
#: the reference's other registered mechanisms (ROADMAP.md queue 1 item 8)
BASELINE_MECHANISMS = ("cdrf", "cdrfh", "drf", "tsf", "uniform")
BACKENDS = ("torch", "numpy")


def solve(problem: AllocationProblem, mechanism: str = "psdsf-rdm",
          backend: str = "torch", placement: str = "level", *,
          device: DeviceLike = None, x0=None, max_rounds: int = 256,
          tol: float = 1e-6, loose_tol: float = 5e-3, fill: str = "event",
          round: str = "gauss", layout: str = "dense",
          accel: str = "none") -> Tuple[Allocation, SolveInfo]:
    """Solve ``problem`` under ``mechanism`` on ``device``.

    ``fill`` ("event"|"bisect"), ``round`` ("gauss"|"jacobi"),
    ``placement`` ("level", or "lexmm", its identity for PS-DSF), ``tol``,
    ``loose_tol``, ``max_rounds`` and the warm start ``x0`` (N, K) mean
    what they mean in the reference. With ``fill="bisect",
    round="jacobi"`` every round goes through the Hopper ``psdsf_fill``
    kernel on the card.
    """
    if mechanism in BASELINE_MECHANISMS:
        raise NotImplementedError(
            f"mechanism {mechanism!r} is not ported to repro_torch yet: "
            f"ROADMAP.md queue 1 item 8 (baselines)")
    if mechanism not in PSDSF_MECHANISMS:
        raise ValueError(f"unknown allocator {mechanism!r}; registered: "
                         f"{', '.join(sorted(PSDSF_MECHANISMS + BASELINE_MECHANISMS))}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}: {backend!r}")
    if backend == "numpy":
        raise NotImplementedError(
            "backend='numpy' is not ported to repro_torch: the numpy "
            "solvers stay in the reference (ROADMAP.md queue 1 item 3)")
    mode = "rdm" if mechanism == "psdsf-rdm" else "tdm"
    check_axes(mode=mode, placement=placement, fill=fill, round=round,
               layout=layout, accel=accel)
    g = gamma_matrix(problem)
    x, rounds, resid = psdsf_solve_torch(
        problem.demands, problem.capacities, problem.weights, g, x0=x0,
        mode=mode, max_rounds=max_rounds, tol=tol, placement=placement,
        fill=fill, round=round, layout=layout, accel=accel, device=device)
    x = x.double().cpu().numpy()
    return (Allocation(problem, x),
            SolveInfo.from_residual(
                rounds, float(resid), float(g.max(initial=1.0)), tol,
                loose_tol, placement=placement,
                stranded_frac=stranded_fraction(problem, x, gamma=g),
                fill_engine=fill,
                fill_iters=rounds * problem.num_servers
                * fill_iter_budget(problem.num_resources, mode, fill),
                layout=layout, bucket_max=0, accel=accel))
