"""Section IV extensions: PS-DSF with *effective capacities*
(gamma-direct), the port of ``repro/core/extensions.py``.

When the effective capacity of a server differs per user (multi-user
diversity on wireless channels, co-processors that only some users can
exploit), there is no demand/capacity matrix at all: the instance is given
directly as gamma[n, i] = tasks/rate user n achieves monopolizing server i.
The VDS definition (Eq. 8) and the TDM feasibility (Eq. 10) only need
gamma, so the server procedure carries over unchanged (the paper's key
observation in Section IV).

:func:`solve_psdsf_gamma_tdm_torch` runs the port's TDM solve
(``psdsf_torch.psdsf_solve_torch(..., mode="tdm")``) on unit demands (N, 1)
and unit capacities (K, 1), as the reference's ``dummy_demands`` does, on
``device`` (``cuda`` unless the caller passes ``device="cpu"``), with its
damping held at its start (``stall=False``): the reference's loop is
undamped Gauss-Seidel, and the engine's stall schedule, which shrinks the
damping to 0.01 when a round's residual falls by less than 10%, stalls a
slowly converging gamma-direct sweep (a 24 x 6 instance the reference
solves in 113 rounds is still ~2e-2 off its totals after 2,000:
``tests/test_torch_extensions.py::test_stall_schedule_off_keeps_the_damping``).
With ``fill="bisect", round="jacobi"`` every round is one event of the Hopper
``psdsf_fill`` kernel in TDM mode on the dense layout, of
``psdsf_fill_bucketed`` on the bucketed one; the Gauss-Seidel and event
fills stay plain torch, as elsewhere in the port.

``GammaProblem`` is the reference's container, copied with its
``ValueError``s; ``fig4_instance_np`` (Example Scenario 1, Figure 4) and
``coprocessor_instance_np`` (Example Scenario 2) build the paper's two
examples.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..device import DeviceLike, resolve_device, to_device
from .layout import BucketedLayout, resolve_layout
from .psdsf_torch import check_axes, psdsf_solve_torch
from .solveinfo import SolveInfo


@dataclasses.dataclass(frozen=True)
class GammaProblem:
    """An effective-capacity instance: gamma (N, K) >= 0, weights (N,)."""
    gamma: np.ndarray
    weights: Optional[np.ndarray] = None

    def __post_init__(self):
        g = np.asarray(self.gamma, dtype=np.float64)
        if g.ndim != 2 or (g < 0).any():
            raise ValueError("gamma must be a nonnegative (N, K) matrix")
        w = (np.ones(g.shape[0]) if self.weights is None
             else np.asarray(self.weights, dtype=np.float64))
        if w.shape != (g.shape[0],) or (w <= 0).any():
            raise ValueError("bad weights")
        object.__setattr__(self, "gamma", g)
        object.__setattr__(self, "weights", w)


def solve_psdsf_gamma_tdm_torch(problem: GammaProblem, max_rounds: int = 200,
                                tol: float = 1e-10, *, fill: str = "event",
                                round: str = "gauss", layout: str = "dense",
                                accel: str = "none",
                                device: DeviceLike = None):
    """PS-DSF over effective capacities (TDM) on ``device``. Returns (x
    (N, K) task rates, time_shares (N, K), ``SolveInfo``), x and the shares
    as float64 numpy arrays like the reference's. ``fill``, ``round`` and
    ``layout`` ("dense", "bucketed", or "auto" resolved from the support of
    gamma) and ``accel`` ("none"|"anderson") as in ``engine.solve``; the
    residual is accepted at ``tol`` x max(1, max gamma), the reference's
    rule."""
    check_axes(mode="tdm", fill=fill, round=round, layout=layout,
               accel=accel)
    dev = resolve_device(device)
    g, w = problem.gamma, problem.weights
    n, k = g.shape
    resolved = resolve_layout(layout, support=g)
    buckets, bucket_max = None, 0
    if resolved == "bucketed":
        lay = BucketedLayout.from_support(g > 0)
        buckets = (to_device(lay.indices, dev), to_device(lay.mask, dev))
        bucket_max = lay.bucket_max
    x, rounds, resid, *hits = psdsf_solve_torch(
        np.ones((n, 1)), np.ones((k, 1)), w, g, mode="tdm",
        max_rounds=max_rounds, tol=tol, fill=fill, round=round,
        layout=resolved, buckets=buckets, accel=accel, stall=False,
        device=dev)
    x = x.cpu().numpy()
    resid = float(resid)
    scale = max(1.0, g.max(initial=1.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        shares = np.where(g > 0, x / np.maximum(g, 1e-300), 0.0)
    hits, rejects = hits or (0, 0)
    return x, shares, SolveInfo(rounds, resid <= tol * scale, resid,
                                fill_engine=fill, layout=resolved,
                                bucket_max=bucket_max, accel=accel,
                                accel_hits=hits, accel_rejects=rejects)


def fig4_instance_np() -> GammaProblem:
    """Figure 4: achievable rates (Mb/s) of two equally-weighted users over
    three channels: user 1 = [1, 1, 0], user 2 = [0, 2/3, 2/3] reproduce
    channel 1 -> user 1, channel 3 -> user 2, channel 2 time-shared 50/50,
    service rates (1.5, 1.0) Mb/s (the reference's derivation from the
    paper's stated outcome and the Theorem 2 fixed-point condition)."""
    return GammaProblem(gamma=np.array([[1.0, 1.0, 0.0],
                                        [0.0, 2.0 / 3.0, 2.0 / 3.0]]))


#: Example Scenario 2's co-processor speedup for the users that can use it
COPROCESSOR_SPEEDUP = 4.0


def coprocessor_instance_np() -> GammaProblem:
    """Example Scenario 2: three servers, server 1 has a co-processor that
    only user 0 can exploit (``COPROCESSOR_SPEEDUP`` x its effective
    throughput there)."""
    base = np.array([[4.0, 2.0, 3.0],
                     [4.0, 2.0, 3.0],
                     [2.0, 1.0, 1.5]])
    speedup = np.ones((3, 3))
    speedup[0, 1] = COPROCESSOR_SPEEDUP
    return GammaProblem(gamma=base * speedup)
