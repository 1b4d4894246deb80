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

The baseline mechanisms run here too: ``cdrfh``, ``tsf`` and ``cdrf``
through ``baselines_torch.solve_baseline_torch`` (the reference's
``solve_baseline_jax``), and the closed forms ``drf`` (on the pooled
relaxation) and ``uniform`` through :func:`_drf_torch` /
:func:`_uniform_torch`, which accept only the default placement, fill,
round, layout and accel, as the reference's ``_reject_placement`` does.

``placement="lexmm"`` is the identity on the level solve for PS-DSF and,
for the global-share mechanisms, the exact flow router on the host
(``flowrouter.lexmm_route_np``, scipy LP certificates), as on the
reference's jitted backend.

``ensure_converged`` is the shared acceptance check the scheduling layers
(``sched.cluster``, ``sched.serving``) call on a solve's ``SolveInfo``;
it raises ``ConvergenceError``.

Not ported, and raising ``NotImplementedError``: the numpy backend (the
numpy solvers stay in the reference).
"""
from __future__ import annotations

from typing import Tuple

from ..device import DeviceLike, resolve_device, to_device
from .baselines_torch import (LEVEL_FILL_MECHANISMS, drf_pooled_allocation,
                              solve_baseline_torch, uniform_share_allocation)
from .gamma import gamma_matrix
from .layout import LAYOUTS, BucketedLayout, resolve_layout
from .psdsf_torch import (ACCEL_ENGINES, UnknownNameError, check_axes,
                          check_placement, psdsf_solve_torch)
from .solveinfo import SolveInfo, fill_iter_budget, stranded_fraction
from .types import Allocation, AllocationProblem

PSDSF_MECHANISMS = ("psdsf-rdm", "psdsf-tdm")
#: the reference's other registered mechanisms: the level fills and the
#: closed forms
BASELINE_MECHANISMS = ("cdrf", "cdrfh", "drf", "tsf", "uniform")
BACKENDS = ("torch", "numpy")


class ConvergenceError(RuntimeError):
    """A solve ended outside even the loose acceptance tolerance."""


def ensure_converged(info: SolveInfo, what: str = "allocator") -> SolveInfo:
    """Shared acceptance check for scheduling layers.

    Accepts tight or loose (``approx``) convergence — the same level the jax
    engine certifies at — and raises ``ConvergenceError`` (never a stripped
    ``assert``) otherwise, with the residual in the message.
    """
    if not info.converged:
        raise ConvergenceError(
            f"{what}: residual {info.residual:.3e} after {info.rounds} "
            f"rounds exceeds the loose acceptance tolerance")
    return info


def _reject_placement_torch(mechanism: str, placement: str, fill: str,
                            round: str, layout: str, accel: str) -> None:
    """Closed-form mechanisms have no placement freedom (drf solves a
    pooled relaxation, uniform IS a fixed placement) and run no per-server
    fill, sweep or outer iteration: only the default of each axis is
    accepted, so a request cannot be silently ignored. The reference's
    ``engine._reject_placement``, with its exception classes."""
    check_placement(placement)
    if placement != "level":
        raise ValueError(
            f"mechanism {mechanism!r} is closed-form and has no placement "
            f"freedom; only placement='level' is accepted, got {placement!r}")
    if fill != "event" or round != "gauss":
        raise ValueError(
            f"mechanism {mechanism!r} is closed-form and runs no per-server "
            f"fill; only fill='event', round='gauss' are accepted, got "
            f"fill={fill!r}, round={round!r}")
    if layout not in LAYOUTS:
        raise ValueError(f"layout must be one of {LAYOUTS}: {layout!r}")
    if layout == "bucketed":
        raise ValueError(
            f"mechanism {mechanism!r} is closed-form and runs no sweep to "
            f"bucket; only layout='dense'/'auto' are accepted")
    if accel not in ACCEL_ENGINES:
        raise ValueError(f"accel must be one of {ACCEL_ENGINES}: {accel!r}")
    if accel != "none":
        raise ValueError(
            f"mechanism {mechanism!r} is closed-form and runs no outer "
            f"iteration to accelerate; only accel='none' is accepted, got "
            f"{accel!r}")


def _drf_torch(problem: AllocationProblem, *, placement: str = "level",
               fill: str = "event", round: str = "gauss",
               layout: str = "auto", accel: str = "none",
               device: DeviceLike = None) -> Tuple[Allocation, SolveInfo]:
    """Classic DRF on the pooled cluster, a host closed form: the
    ``Allocation`` lives on the pooled relaxation (x of shape (N, 1)).
    Checks ``device`` like every entry point, though nothing runs there."""
    resolve_device(device)
    _reject_placement_torch("drf", placement, fill, round, layout, accel)
    return drf_pooled_allocation(problem)


def _uniform_torch(problem: AllocationProblem, *, placement: str = "level",
                   fill: str = "event", round: str = "gauss",
                   layout: str = "auto", accel: str = "none",
                   device: DeviceLike = None
                   ) -> Tuple[Allocation, SolveInfo]:
    """The phi-proportional share of every server, a host closed form.
    Checks ``device`` like every entry point, though nothing runs there."""
    resolve_device(device)
    _reject_placement_torch("uniform", placement, fill, round, layout, accel)
    return uniform_share_allocation(problem)


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
    counters. ``placement="headroom"`` follows the PS-DSF level solve with
    its repack-and-refill passes (dense, their refills through the same
    fill kernel).

    ``mechanism`` "cdrfh"/"tsf"/"cdrf" solves the baseline level fill
    (``placement`` "level" or "headroom", the routed global fill) and
    "drf"/"uniform" the closed forms, which take only each axis's
    default. A baseline at ``placement="lexmm"`` runs the host flow router
    (dense only; the info's rounds are its stages). An unknown mechanism or placement raises ``UnknownNameError``
    (a ``KeyError`` and a ``ValueError``).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}: {backend!r}")
    check_placement(placement)
    if mechanism not in PSDSF_MECHANISMS + BASELINE_MECHANISMS:
        raise UnknownNameError(
            f"unknown allocator {mechanism!r}; registered: "
            f"{', '.join(sorted(PSDSF_MECHANISMS + BASELINE_MECHANISMS))}")
    if backend == "numpy":
        raise NotImplementedError(
            "backend='numpy' is not ported to repro_torch: the numpy "
            "solvers stay in the reference (ROADMAP.md, north star: only code "
            "written in JAX or Pallas is ported)")
    axes = dict(placement=placement, fill=fill, round=round, layout=layout,
                accel=accel, device=device)
    if mechanism == "drf":
        return _drf_torch(problem, **axes)
    if mechanism == "uniform":
        return _uniform_torch(problem, **axes)
    if mechanism in LEVEL_FILL_MECHANISMS:
        return solve_baseline_torch(problem, mechanism, x0=x0,
                                    max_rounds=max_rounds, tol=tol,
                                    loose_tol=loose_tol, **axes)
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
