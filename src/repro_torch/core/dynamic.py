"""Distributed / asynchronous PS-DSF (Section III-D and the Section V
experiment): the port of ``repro/core/dynamic.py``.

Each server executes the *server procedure* independently every T seconds
using only its local capacities and the global task counts x_n.
``DistributedPSDSF.tick(servers)`` rebuilds the chosen servers' allocations
(all servers = one synchronous round; subsets or permuted orders =
asynchronous execution); user churn is an activity mask.

The tick runs on tensors (``engine="torch"``, the port of the reference's
``engine="jax"``): Gauss-Seidel over the listed servers with the port's
per-server fills (``psdsf_torch._fill_one_server_*``), on the dense layout
(``_tick_torch``) or on per-server eligibility buckets
(``_tick_torch_bucketed``, O(nnz) per full tick). Like the reference's jnp
tick they stay plain torch: a tick is sequential over servers, and no
Pallas kernel runs in it. ``min_vds_guarded``, the Eq. 16 telemetry of the
tick and of the churn simulator, runs through the Hopper ``psdsf_vds``
kernel for tensors on the card.

``placement="headroom"``/``"bestfit"`` repack the state after each tick,
as the reference does, through the port's host numpy copy of
``placement.repack_pass`` (``placement_torch.repack_pass_np``).

Not ported, and raising ``NotImplementedError`` with the ROADMAP item: the
numpy oracle engine (the numpy solvers stay in the reference) and
``routed_allocation`` (queue 1 item 5, baselines: host lexmm router).
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device
from ..kernels.psdsf_vds.ops import min_vds
from .gamma import gamma_matrix
from .layout import BucketedLayout, resolve_layout
from .placement_torch import repack_pass_np
from .psdsf_torch import (ANDERSON_MEMORY, _server_fill, check_axes,
                          check_placement)
from .types import Allocation, AllocationProblem

#: tick engines: ``torch`` runs; ``numpy`` (the reference's oracle) stays in
#: the reference
ENGINES = ("torch", "numpy")
PRECISIONS = ("highest", "fast")


def min_vds_guarded(x, weights, gamma, active, *, device: DeviceLike = None):
    """Per server, min_n x_n / (phi_n gamma[n, i]) over the active users
    with positive weight, and the user attaining it.

    x (N, K), weights (N,), gamma (N, K), active (N,) bool: tensors or
    numpy arrays, moved to ``device`` (default ``cuda``). The mask is
    applied BEFORE the division, so a zero-weight user is excluded exactly
    like an inactive one instead of turning a server's minimum into inf or
    NaN; a server without any such user reports 3e38. Returns (min (K,)
    float32, argmin (K,) int32) on ``device``.
    """
    dev = resolve_device(device)
    x, weights, gamma = (to_device(a, dev) for a in (x, weights, gamma))
    mask = to_device(active, dev, torch.bool) & (weights > 0)
    one = torch.ones((), dtype=weights.dtype, device=dev)
    x_over_phi = torch.where(mask, x.sum(dim=1) / torch.where(mask, weights,
                                                              one),
                             torch.zeros((), dtype=x.dtype, device=dev))
    return min_vds(x_over_phi, torch.where(mask[:, None], gamma,
                                           torch.zeros((), dtype=gamma.dtype,
                                                       device=dev)))


def _tick_torch(x, demands, capacities, weights, gamma, active, servers, *,
                mode, fill):
    """One visit sequence on the dense layout (port of ``dynamic.
    _tick_jax_fn``): each server of ``servers`` in turn refills its column
    against the current row sums. Returns the new (N, K) x."""
    fill_fn = _server_fill(mode, fill)
    gamma = torch.where(active[:, None], gamma, torch.zeros_like(gamma))
    x = x.clone()
    for i in servers:
        x_ext = x.sum(dim=1) - x[:, i]
        x[:, i] = fill_fn(capacities[i:i + 1], demands, weights,
                          gamma[:, i:i + 1], x_ext[:, None])[:, 0]
    return x


def _tick_torch_bucketed(x, dem_b, capacities, phi_b, gam_b, idx, mask,
                         active, servers, *, mode, fill):
    """Bucketed twin of :func:`_tick_torch` (port of ``dynamic.
    _tick_jax_bucketed_fn``): each server fills its (Bmax,) eligibility
    bucket, and the per-user row sums are kept by scatter-adds of each
    server's delta, O(Bmax) a server. The dense state goes through the
    bucket gather and a scatter-ADD back (padded slots add exact zeros)."""
    fill_fn = _server_fill(mode, fill)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    cols = torch.arange(idx.shape[0], device=x.device)[:, None].expand_as(idx)
    xb = torch.where(mask, x[idx, cols], zero)
    xsum = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    xsum.index_add_(0, idx.reshape(-1), xb.reshape(-1))
    for i in servers:
        u, m_i = idx[i], mask[i]
        g_i = torch.where(active[u] & m_i, gam_b[i], zero)
        x_ext = xsum[u] - xb[i]
        xi = fill_fn(capacities[i:i + 1], dem_b[i], phi_b[i], g_i[:, None],
                     x_ext[:, None])[:, 0]
        xi = torch.where(m_i, xi, zero)
        xsum.index_add_(0, u, xi - xb[i])
        xb[i] = xi
    return torch.zeros_like(x).index_put_(
        (idx, cols), torch.where(mask, xb, zero), accumulate=True)


class DistributedPSDSF:
    """The asynchronous server procedure on tensors (port of the
    reference's ``DistributedPSDSF`` with ``engine="jax"``).

    ``engine="torch"`` (default) ticks on ``device`` (default ``cuda``);
    ``engine="numpy"``, the reference's oracle, is not ported.
    ``precision="highest"`` ticks in float64 and ``"fast"`` in float32
    (torch has float64 on the card, so "highest" runs here, where the
    reference's jax engine raises). ``fill`` ("event"/"bisect"), ``layout``
    ("dense"/"bucketed"/"auto", resolved by support density; exposed as
    ``self.layout`` / ``self.bucket_max``) and ``accel`` ("none"/
    "anderson") as in the reference: Anderson mixes host-side ACROSS
    synchronous full ticks, each mixed candidate certified by a second full
    tick and kept only if it shrinks the tick residual; partial or shuffled
    ticks and ``set_active`` restart the history, and ``accel_hits`` /
    ``accel_rejects`` count the candidates. ``placement`` "level" and
    "lexmm" tick unchanged (the per-server fill is the level placement and
    the per-server lexicographic optimum); "headroom"/"bestfit" follow
    every tick with one totals-preserving repack on the host (proportional
    or best-fit), over the active users' gamma.

    ``self.x`` is the (N, K) float64 host state, as in the reference; each
    tick moves it to the device, runs the visit sequence there and copies
    it back.
    """

    def __init__(self, problem: AllocationProblem, mode: str = "rdm",
                 seed: int = 0, engine: str = "torch",
                 precision: str = "highest", placement: str = "level",
                 fill: str = "event", layout: str = "auto",
                 accel: str = "none", device: DeviceLike = None):
        check_placement(placement)
        check_axes(mode=mode, fill=fill, layout=layout, accel=accel)
        if engine not in ENGINES:
            raise ValueError(
                f"engine must be one of {ENGINES}: {engine!r} (the port's "
                f"device engine, the reference's engine='jax', is 'torch')")
        if precision not in PRECISIONS:
            raise ValueError(
                f"precision must be 'highest' or 'fast': {precision!r}")
        if engine == "numpy":
            raise NotImplementedError(
                "engine='numpy' is not ported to repro_torch: the numpy "
                "solvers stay in the reference (ROADMAP.md, north star: "
                "only code written in JAX or Pallas is ported)")
        self.device = resolve_device(device)
        self.gamma = gamma_matrix(problem)
        self.layout = resolve_layout(layout, support=self.gamma)
        self.problem = problem
        self.mode = mode
        self.engine = engine
        self.fill = fill
        self.placement = placement
        self.accel = accel
        self.accel_hits = 0
        self.accel_rejects = 0
        self._hist_f: list = []      # tick-to-tick Anderson history
        self._hist_g: list = []
        self.x = np.zeros((problem.num_users, problem.num_servers))
        self.active = np.ones(problem.num_users, dtype=bool)
        self._rng = np.random.default_rng(seed)
        dt = torch.float64 if precision == "highest" else torch.float32
        dev = self.device
        self._dtype = dt
        self._demands, self._caps, self._weights = (
            to_device(a, dev, dt) for a in (problem.demands,
                                            problem.capacities,
                                            problem.weights))
        self._blayout = None
        if self.layout == "bucketed":
            bl = BucketedLayout.from_support(self.gamma > 0)
            self._blayout = bl
            self._idx = to_device(bl.indices, dev).long()
            self._mask = to_device(bl.mask, dev)
            self._dem_b = self._demands[self._idx]
            self._phi_b = self._weights[self._idx]
            self._gam_b = to_device(np.where(
                bl.mask, np.take_along_axis(self.gamma.T, bl.indices,
                                            axis=1), 0.0), dev, dt)
        else:
            self._gamma = to_device(self.gamma, dev, dt)
        self.bucket_max = (0 if self._blayout is None
                           else self._blayout.bucket_max)

    # -- churn -------------------------------------------------------------
    def set_active(self, user: int, active: bool) -> None:
        """Arrival/departure: departures also release the user's tasks.
        Churn changes the tick map, so the Anderson history restarts."""
        self.active[user] = active
        if not active:
            self.x[user, :] = 0.0      # departing user releases its tasks
        self._hist_f = []
        self._hist_g = []

    # -- the per-server procedure -------------------------------------------
    def tick(self, servers: Optional[Iterable[int]] = None,
             shuffle: bool = False) -> None:
        """One asynchronous round of Algorithm 1: each listed server (all
        by default) runs its local PS-DSF procedure against current state,
        in the listed order, or in an order drawn from the instance's numpy
        rng (``seed``) when ``shuffle``. Under ``accel="anderson"`` a
        synchronous full tick additionally mixes the tick-to-tick history;
        partial or shuffled visits tick plainly and restart it. Under
        ``placement="headroom"``/``"bestfit"`` the tick ends with one
        repack."""
        p = self.problem
        full = servers is None and not shuffle
        idx: Sequence[int] = list(range(p.num_servers) if servers is None
                                  else servers)
        if shuffle:
            self._rng.shuffle(idx)
        if self.accel == "anderson" and full:
            self._tick_anderson(idx)
        else:
            if self.accel == "anderson":
                # the mixing history models the synchronous full-tick map;
                # an asynchronous visit changes that map: restart
                self._hist_f = []
                self._hist_g = []
            self._tick_once(idx)
        self._repack_after_tick()

    def _tick_once(self, idx: Sequence[int]) -> None:
        """One plain visit sequence (no mixing): the map the Anderson layer
        accelerates and the safeguard certifies with."""
        servers = [int(i) for i in idx]
        dev = self.device
        x = to_device(self.x, dev, self._dtype)
        active = to_device(self.active, dev, torch.bool)
        if self._blayout is not None:
            x = _tick_torch_bucketed(
                x, self._dem_b, self._caps, self._phi_b, self._gam_b,
                self._idx, self._mask, active, servers, mode=self.mode,
                fill=self.fill)
        else:
            x = _tick_torch(x, self._demands, self._caps, self._weights,
                            self._gamma, active, servers, mode=self.mode,
                            fill=self.fill)
        self.x = x.to(torch.float64).cpu().numpy().copy()

    def _tick_anderson(self, idx: Sequence[int]) -> None:
        """Host-side safeguarded Anderson mixing across full ticks, as in
        the reference: one plain tick always runs first; a mixed candidate
        (numpy lstsq over the tick-to-tick difference history) is evaluated
        by a SECOND full tick and kept only if that tick's residual beats
        the plain one, so ``self.x`` always ends on the output of a real
        server-procedure round."""
        x_prev = self.x.copy()
        self._tick_once(idx)
        g = self.x.copy()
        resid = float(np.abs(g - x_prev).max())
        f = (g - x_prev).ravel()
        self._hist_f.append(f)
        self._hist_g.append(g.ravel())
        if len(self._hist_f) > ANDERSON_MEMORY + 1:
            self._hist_f.pop(0)
            self._hist_g.pop(0)
        if len(self._hist_f) < 2 or resid == 0.0:
            return
        hf, hg = self._hist_f, self._hist_g
        df = np.stack([hf[j + 1] - hf[j] for j in range(len(hf) - 1)], axis=1)
        dg = np.stack([hg[j + 1] - hg[j] for j in range(len(hg) - 1)], axis=1)
        theta, *_ = np.linalg.lstsq(df, f, rcond=None)
        cand = np.maximum(hg[-1] - dg @ theta, 0.0).reshape(self.x.shape)
        self.x = cand.copy()
        self._tick_once(idx)                 # safeguard evaluation tick
        g_c = self.x.copy()
        resid_c = float(np.abs(g_c - cand).max())
        if np.isfinite(resid_c) and resid_c < resid:
            self.accel_hits += 1
            self._hist_f.append((g_c - cand).ravel())
            self._hist_g.append(g_c.ravel())
            if len(self._hist_f) > ANDERSON_MEMORY + 1:
                self._hist_f.pop(0)
                self._hist_g.pop(0)
        else:
            self.accel_rejects += 1
            self.x = g                       # fall back to the plain tick
            self._hist_f = [f]
            self._hist_g = [g.ravel()]

    def _repack_after_tick(self) -> None:
        """headroom/bestfit: one totals-preserving repack of the state over
        the active users' gamma; level/lexmm ticks are left as they are."""
        if self.placement not in ("headroom", "bestfit"):
            return
        p = self.problem
        g = np.where(self.active[:, None], self.gamma, 0.0)
        self.x = repack_pass_np(p.demands, p.capacities, self.x, g,
                                mode=self.mode,
                                greedy=self.placement == "bestfit")

    def routed_allocation(self, mechanism: str = "tsf") -> Allocation:
        """The reference's exact lexmm-routed allocation of a global-share
        mechanism, certified by host-side LP solves."""
        raise NotImplementedError(
            f"routed_allocation({mechanism!r}) is not ported to repro_torch "
            f"yet: ROADMAP.md queue 1 item 5 (baselines: host lexmm router)")

    # -- telemetry ----------------------------------------------------------
    def min_vds(self, interpret: bool = True):
        """Per-server (min normalized VDS (K,) float32, argmin user (K,)
        int32) over active users, as numpy arrays: Eq. 16 through
        :func:`min_vds_guarded`, one ``psdsf_vds`` kernel launch on the
        card. Servers where no active user is eligible report 3e38;
        zero-weight users are excluded like inactive ones. ``interpret``
        (the reference's Pallas-interpreter switch) is accepted and
        ignored: the device decides."""
        del interpret
        mn, arg = min_vds_guarded(self.x, self.problem.weights, self.gamma,
                                  self.active, device=self.device)
        return mn.cpu().numpy(), arg.cpu().numpy()

    def allocation(self) -> Allocation:
        """Snapshot of the current state as an :class:`Allocation`."""
        return Allocation(self.problem, self.x.copy())

    def utilization(self) -> np.ndarray:
        """(K, R) resource utilization of the current state."""
        return self.allocation().utilization()
