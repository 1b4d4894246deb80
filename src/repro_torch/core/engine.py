"""One-call entry of the port: ``solve(problem, mechanism, ...)``.

The counterpart of ``repro.core.engine.solve`` with ``backend="jax"`` for
the PS-DSF mechanisms, i.e. of ``_solve_psdsf_via_jax``: it solves on the
device (``cuda`` unless the caller passes ``device="cpu"``) and returns the
same ``(Allocation, SolveInfo)`` pair with every field the reference fills.
A problem's float64 arrays go through as float64 (torch has no x64 switch
to turn off), so an ``engine.solve`` is a float64 solve; call
``psdsf_torch.psdsf_solve_torch`` with float32 arrays for a float32 one.

``layout`` defaults to ``"auto"``, as in the reference: it resolves on the
host from the support of ``gamma_matrix(problem)`` (``layout.
resolve_layout``), and a sparse instance runs the bucketed core on a
``BucketedLayout`` built from that support.

Not ported yet, and raising ``NotImplementedError`` with the ROADMAP item:
the baseline mechanisms, the numpy backend and ``placement="headroom"``.
"""
from __future__ import annotations

from typing import Tuple

from ..device import DeviceLike, resolve_device, to_device
from .gamma import gamma_matrix
from .layout import BucketedLayout, resolve_layout
from .psdsf_torch import check_axes, psdsf_solve_torch
from .solveinfo import SolveInfo, fill_iter_budget, stranded_fraction
from .types import Allocation, AllocationProblem

PSDSF_MECHANISMS = ("psdsf-rdm", "psdsf-tdm")
#: the reference's other registered mechanisms (ROADMAP.md queue 1 item 5,
#: baselines)
BASELINE_MECHANISMS = ("cdrf", "cdrfh", "drf", "tsf", "uniform")
BACKENDS = ("torch", "numpy")


def solve(problem: AllocationProblem, mechanism: str = "psdsf-rdm",
          backend: str = "torch", placement: str = "level", *,
          device: DeviceLike = None, x0=None, max_rounds: int = 256,
          tol: float = 1e-6, loose_tol: float = 5e-3, fill: str = "event",
          round: str = "gauss", layout: str = "auto",
          accel: str = "none") -> Tuple[Allocation, SolveInfo]:
    """Solve ``problem`` under ``mechanism`` on ``device``.

    ``fill`` ("event"|"bisect"), ``round`` ("gauss"|"jacobi"),
    ``placement`` ("level", or "lexmm", its identity for PS-DSF), ``tol``,
    ``loose_tol``, ``max_rounds`` and the warm start ``x0`` (N, K) mean
    what they mean in the reference. With ``fill="bisect",
    round="jacobi"`` every round goes through the Hopper ``psdsf_fill``
    kernel on the card (``psdsf_fill_bucketed`` on the bucketed layout).
    ``layout`` ("auto"|"dense"|"bucketed") and ``accel``
    ("none"|"anderson") as in the reference; the returned ``SolveInfo``
    carries the resolved layout, the bucket width and the Anderson
    counters.
    """
    if mechanism in BASELINE_MECHANISMS:
        raise NotImplementedError(
            f"mechanism {mechanism!r} is not ported to repro_torch yet: "
            f"ROADMAP.md queue 1 item 5 (baselines)")
    if mechanism not in PSDSF_MECHANISMS:
        raise ValueError(f"unknown allocator {mechanism!r}; registered: "
                         f"{', '.join(sorted(PSDSF_MECHANISMS + BASELINE_MECHANISMS))}")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}: {backend!r}")
    if backend == "numpy":
        raise NotImplementedError(
            "backend='numpy' is not ported to repro_torch: the numpy "
            "solvers stay in the reference (ROADMAP.md, north star: only code "
            "written in JAX or Pallas is ported)")
    mode = "rdm" if mechanism == "psdsf-rdm" else "tdm"
    check_axes(mode=mode, placement=placement, fill=fill, round=round,
               layout=layout, accel=accel)
    dev = resolve_device(device)
    g = gamma_matrix(problem)
    resolved = resolve_layout(layout, support=g)
    buckets, bucket_max = None, 0
    if resolved == "bucketed":
        blayout = BucketedLayout.from_support(g > 0)
        buckets = (to_device(blayout.indices, dev),
                   to_device(blayout.mask, dev))
        bucket_max = blayout.bucket_max
    out = psdsf_solve_torch(
        problem.demands, problem.capacities, problem.weights, g, x0=x0,
        mode=mode, max_rounds=max_rounds, tol=tol, placement=placement,
        fill=fill, round=round, layout=resolved, buckets=buckets,
        accel=accel, device=dev)
    x, rounds, resid = out[:3]
    hits, rejects = out[3:] if accel == "anderson" else (0, 0)
    x = x.double().cpu().numpy()
    return (Allocation(problem, x),
            SolveInfo.from_residual(
                rounds, float(resid), float(g.max(initial=1.0)), tol,
                loose_tol, placement=placement,
                stranded_frac=stranded_fraction(problem, x, gamma=g),
                fill_engine=fill,
                fill_iters=rounds * problem.num_servers
                * fill_iter_budget(problem.num_resources, mode, fill),
                layout=resolved, bucket_max=bucket_max, accel=accel,
                accel_hits=hits, accel_rejects=rejects))
