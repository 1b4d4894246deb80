"""The uniform solve record and the host-side quantities it reports.

The port's own copy of what ``repro.core.placement`` defines for the
jitted solve path: ``SolveInfo`` with every field and ``from_residual``'s
tight/loose acceptance bands, ``stranded_fraction``, ``fill_iter_budget``
and the bisection-step constants.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .gamma import gamma_matrix
from .types import AllocationProblem

#: bisection steps per saturation event of the ``bisect`` fill: 2^-48
#: shrinks the level bracket to ~3.6e-15 relative in float64; past 26 steps
#: a float32 bracket is below ulp and further steps change nothing
BISECT_STEPS = 48
BISECT_STEPS_F32 = 26

#: per-server fill engines
FILL_ENGINES = ("event", "bisect")


@dataclasses.dataclass
class SolveInfo:
    """Uniform solve record: convergence, placement, waste, and the fill
    and layout observability. The router fields (``lp_calls`` ..
    ``router_mode``) and ``servers_skipped`` belong to host-side engines
    the dense solve does not run; they stay at their zero defaults, as on
    the reference's jitted path."""

    rounds: int
    converged: bool
    residual: float
    approx: bool = False     # converged only to the loose tolerance
    placement: str = "level"           # strategy that produced the layout
    stranded_frac: float = float("nan")  # demandable capacity left unused
    lp_calls: int = 0
    lp_iters: int = 0
    warm_hits: int = 0
    warm_fallbacks: int = 0
    solve_ms: float = 0.0
    stage_ms: tuple = ()
    router_mode: str = ""
    fill_engine: str = "event"  # per-server fill engine
    fill_iters: int = 0      # inner fill iterations (events x bisect steps)
    layout: str = "dense"    # solve layout
    bucket_max: int = 0      # padded bucket width (bucketed layout only)
    servers_skipped: int = 0
    accel: str = "none"      # outer-iteration accelerator
    accel_hits: int = 0
    accel_rejects: int = 0
    rounds_to_tol: int = 0   # first round meeting the tight tol (0 if never)

    @classmethod
    def from_residual(cls, rounds: int, residual: float, scale: float,
                      tol: float, loose_tol: float = 5e-3,
                      placement: str = "level",
                      stranded_frac: float = float("nan"),
                      fill_engine: str = "event", fill_iters: int = 0,
                      layout: str = "dense", bucket_max: int = 0,
                      accel: str = "none", accel_hits: int = 0,
                      accel_rejects: int = 0) -> "SolveInfo":
        """The acceptance contract applied to a (rounds, residual) pair:
        ``converged`` when the residual passes ``tol * scale`` or, with
        ``approx=True``, the loose ``loose_tol * scale``."""
        scale = max(1.0, scale)
        converged = residual <= tol * scale
        approx = not converged and residual <= loose_tol * scale
        return cls(rounds, converged or approx, residual, approx=approx,
                   placement=placement, stranded_frac=stranded_frac,
                   fill_engine=fill_engine, fill_iters=fill_iters,
                   layout=layout, bucket_max=bucket_max, accel=accel,
                   accel_hits=accel_hits, accel_rejects=accel_rejects,
                   rounds_to_tol=rounds if converged else 0)


def demandable_mask(problem: AllocationProblem,
                    gamma: Optional[np.ndarray] = None) -> np.ndarray:
    """(K, R) bool: cap[i, r] > 0 and some user eligible on i demands r."""
    g = gamma_matrix(problem) if gamma is None else gamma
    wanted = (g.T > 0).astype(float) @ (problem.demands > 0)
    return (problem.capacities > 0) & (wanted > 0)


def stranded_fraction(problem: AllocationProblem, x: np.ndarray,
                      gamma: Optional[np.ndarray] = None) -> float:
    """Fraction of demandable capacity an allocation leaves unused."""
    mask = demandable_mask(problem, gamma)
    total = problem.capacities[mask].sum()
    if total <= 0:
        return 0.0
    usage = np.einsum("nk,nr->kr", x, problem.demands)
    return float(1.0 - min(usage[mask].sum() / total, 1.0))


def fill_iter_budget(num_resources: int, mode: str, fill: str) -> int:
    """Inner-iteration budget of one per-server fill: saturation events
    (<= R+1, one for TDM) for ``event``, events x bisection steps for
    ``bisect``; ``SolveInfo.fill_iters`` totals it over a solve."""
    if fill not in FILL_ENGINES:
        raise ValueError(f"fill must be one of {FILL_ENGINES}: {fill!r}")
    events = 1 if mode == "tdm" else num_resources + 1
    return events * (BISECT_STEPS if fill == "bisect" else 1)
