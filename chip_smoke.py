#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py              # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse   # control flow only, CPU, tiny sizes

Builds the port's Hopper kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, all started together), then:

1. prints the card (``nvidia-smi`` name and power limit);
2. solves the paper's Fig. 1 and Fig. 2 examples (RDM and TDM) through
   ``engine.solve(..., fill="bisect", round="jacobi")`` on the card and
   checks the paper's values;
3. holds each kernel against its plain PyTorch version on the card, at the
   main paths' shapes (one dense fill event of the 20,000 x 256 datacenter
   pin in float64 and of 20,000 x 1,024 in float32, one bucketed fill event
   on the same two instances' buckets, the VDS reduction over the pin's
   gamma), and times both with CUDA events: a kernel (and a library call)
   around the replay of a CUDA graph of many warm calls, which leaves out
   the host's time to launch them, and again back to back; the plain
   version back to back;
4. drives the dense main path with every launch count set to 0: the
   20,000 x 256 pin in float64 (``engine.solve``, Jacobi rounds, bisect
   fill, ``layout="dense"``, 32 rounds at tol=0), its ``min_vds_guarded``
   telemetry, the 20,000 x 1,024 instance in float32
   (``psdsf_solve_torch``, dense), and its telemetry; then checks the
   outputs (finite, non-negative, feasible), the float64 solve against the
   same solve with the plain fill to 1e-9, and the telemetry against its
   plain version;
5. drives the sparse main path the same way, counts set to 0 again: the pin
   through ``engine.solve`` at its default ``layout="auto"`` (which must
   resolve to the bucketed layout with Bmax 692 and launch the bucketed
   kernel 5 x 32 times), the 20,000 x 1,024 instance through
   ``psdsf_solve_torch(layout="bucketed")``, and the telemetry of each;
   checks the outputs, the bucketed float64 solve against the dense one
   to 1e-9 and against the plain-driven bucketed solve, and prints the
   layout build's host time and the dense-vs-bucketed walls;
6. profiles 32 Jacobi rounds of each layout for the device-time breakdown;
7. drives the churn loop on the pin, counts set to 0 again: a
   ``ChurnSimulator`` (``layout="auto"``, which must resolve to the buckets;
   Jacobi rounds, bisect fill, 32 rounds at tol 1e-6, float32) stepped to
   the t = 0 equilibrium and then through ``poisson_churn_events`` (horizon
   12, 40 arrivals and 40 departures a tick, degrade rate 0.25, seed 2);
   checks that the bucketed kernel launched 5 x the records' rounds and the
   VDS kernel once a record, prints the ticks' solve times, rounds, events
   and walls, holds the run against the same stream driven with the plain
   versions and against a run on the dense layout (the dense kernel), and
   profiles one more tick for the device-time breakdown;
8. drives the tick layer on the pin: ``DistributedPSDSF`` (float32, bisect
   fill, ``layout="auto"``) for one full tick, a departure and a tick over
   the departed user's servers, then ``min_vds`` (one VDS launch), held
   against the same calls on the CPU;
9. drives ``psdsf_resolve_batched`` over four scenarios of the pin, each
   with one server degraded to 0.5 and its restricted sweep over that
   server and the servers its users are eligible on, warm from the float64
   fixed point of step 4 (bucketed, Jacobi, bisect): the bucketed kernel
   must launch 5 x the rounds, and each scenario must equal its own
   unbatched warm-started solve (the same two phases through the bucketed
   core) to 1e-9 with equal round counts;
10. drives ``placement="headroom"`` on the pin: ``engine.solve(pin,
   "psdsf-rdm", placement="headroom")`` in float64 on the dense layout
   (Jacobi rounds of the bisect fill, 32 at tol=0 for the level solve and
   each refill), its wall split into the level solve, the repack passes
   and the refills, ``psdsf_fill`` launched 5 x all their rounds; held
   against the same solve with the plain versions patched in (1e-9, equal
   rounds), then one repack pass and its refill profiled (device trace
   only) on a 5,000 x 256 cut of the generator;
11. drives the baselines on the pin: ``engine.solve`` for tsf, cdrf and
   cdrfh at level placement (float64, Jacobi, bisect, 32 rounds at tol=0)
   on the dense layout and on the buckets, each held against its
   plain-driven solve (1e-9, equal rounds) with 5 x 32 launches of the
   layout's fill kernel; the routed headroom fill of tsf at the pin (no
   kernel; held against the CPU on a 2,000 x 64 cut); one tsf level solve
   profiled;
12. drives ``ChurnSimulator(pin, mechanism="tsf")`` (float32, buckets,
   Jacobi, bisect) over t = 0 and the first 4 ticks of step 7's stream:
   bucketed launches 5 x the rounds, one VDS launch a record; held against
   the plain-driven stream (rounds equal, per-user totals and min_vds
   within PATH_F32_REL, bottleneck servers tie-aware; a baseline's split
   across a user's servers is not pinned by its fixed point, so it is
   printed, not held); one more tick profiled;
13. drives ``placement="lexmm"`` on a 2,000 x 64 cut of the pin's generator
   (the router's LPs run on the host): ``engine.solve`` for tsf, cdrfh and
   cdrf (no kernel), each held to the one-shot cold router (per-user
   totals within 1e-6, equal stages; the cold routes run in a pool of
   three processes beside the warm solves) and checked feasible, with the
   LP path that ran (scipy's direct HiGHS wrapper or public ``linprog``);
   ``ChurnSimulator(cut, "tsf", placement="lexmm")`` over t = 0 and 4
   ticks of a seeded stream, one ``psdsf_vds`` launch a record, held
   against the plain-driven stream (router fields equal, per-user totals
   and min_vds within PATH_F32_REL, bottleneck servers tie-aware); and
   ``DistributedPSDSF(cut).routed_allocation("tsf")`` across a departure,
   an arrival and no change (modes warm, incremental, fallback, verify);
14. drives the scheduler layers on seeded fleets of 20,000 jobs on 256
   pods and 20,000 tenants on 256 replica groups: ``schedule_detail``
   (float64, Jacobi rounds of the bisect fill, ``SCHED_ROUNDS``) on the
   dense layout, on the buckets and at ``layout="auto"``, 6 launches of
   the layout's fill kernel a round, each held against its plain-driven
   twin and dense against bucketed (1e-9, equal rounds);
   ``admitted_rates`` the same way on the dense layout (4 launches a
   round); ``DynamicDispatcher`` (float32, bisect) for three full ticks
   with tenant departures, on the card and on the CPU, and its
   ``min_vds`` against the plain version; one ``schedule_detail``
   profiled for the idle share;
15. holds the attention kernels against their plain versions at
   qwen3_1_7b's widths (16 query and 8 kv heads, head_dim 128, bfloat16):
   ``flash_attention`` at S 1,024, a ragged S 1,000, 512 and 128 (each call
   must take its Hopper body: TMA and wgmma), ``decode_attention`` over 8
   slots of a 2,048-row cache with one length per slot (1, the whole cache,
   past the cache, ragged) and over one 32,768-row cache; times each kernel
   and ``F.scaled_dot_product_attention``, a yardstick the port never
   calls, in turns (kernel, SDPA, SDPA, kernel); then times the Hopper
   flash body at both of its block sizes (64 and 128 query rows) at S 128
   to 1,024 beside the one its wrapper picks;
16. drives the serving path with every launch count set to 0: a
   ``ServingEngine`` on the full qwen3_1_7b config in bfloat16 (params from
   the port's seeded init on the card), 8 slots of 2,048 rows, 16 requests
   from two tenants (gold weight 2, free weight 1) with prompts of 128-1,024
   tokens and 32 new tokens each; checks completion, token ids, finite
   logits and that every prefill launched ``flash_attention`` (its Hopper
   body) and every decode step ``decode_attention`` once per layer; then
   profiles a short serving window for the device's idle share;
17. runs a 2-layer full-width model on the card with the kernels and again
   with the plain versions, on the same params and tokens, and holds the
   prefill and decode logits of the two runs together;
18. holds ``ssd_scan`` against its plain version (float32 on the card) at
   mamba2_1_3b's prefill shape (B 1, S 1,024, 64 heads x 64, N 128, chunk
   128) in bfloat16, at a ragged S 1,000, at S 512 and in float32, called
   as the model calls it (``ops.ssd_chunked`` on slices of one conv
   output, y written through strides): y and the final state; times both
   (no single PyTorch call computes it);
19. drives the Mamba-2 serving path the same way, counts set to 0 again:
   a ``ServingEngine`` on the full mamba2_1_3b config in bfloat16, 8
   slots, the same 16 requests' shape of traffic; checks completion,
   token ids, finite logits and one ``ssd_scan`` launch per layer and
   prefill; profiles a short window for the idle share; then holds a
   2-layer full-width model's logits with the kernel against the plain
   version's;
20. prints the ``kernels`` JSON line, the ``nvidia-smi`` line, and as its
   last line ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero without the last line. Without a CUDA device,
or without the repository's ``src/`` beside it, it fails at once. With
``--rehearse`` it runs every phase on the CPU at tiny sizes through the plain
versions (the serving phases on the qwen3_1_7b and mamba2_1_3b smoke
configs), skips what needs the card, and never prints a result line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

#: NVIDIA H100 SXM data sheet: HBM3 rate, float32 and float64 rates outside
#: the tensor cores (dense), all at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
#: dense bfloat16 tensor-core rate of the same data sheet, the attention
#: kernels' operations bound (the work they do, whatever units do it)
PEAK_BF16_FLOPS = 989e12

F64_ATOL = 1e-9            # float64 parity bound (tests/test_torch_*.py)
F32_REL = 5e-6             # float32 bound, times max(1, |plain|)
VDS_RTOL = 1e-6            # VDS minimum; argmins must be equal
#: float32 paths on the card vs the same path with the plain versions, on
#: the CPU or on another layout (churn: ~13 re-solves, ~400 Jacobi rounds
#: of float32 fills; tick: one bisect fill a server): each event's kernel
#: agrees with its plain version to a few float32 ulps (F32_REL holds it to
#: 5e-6), and the damped sweep carries such a difference forward without
#: amplifying it, so ~400 rounds of a few ulps (1.2e-7 each) stay under
#: 1e-4 x max(1, max|x|); min_vds (a ratio of x) within 1e-4 relative;
#: round counts, argmins and bottleneck servers equal
PATH_F32_REL = 1e-4
#: attention kernel (bfloat16 out) vs plain version in float32: the kernel
#: rounds its float32 result to bfloat16 once (2^-9 relative) after summing
#: in another order (flash on the tensor cores also rounds the softmax
#: weights to bfloat16, 2^-9 relative each, which averages out over a
#: row); bound 2^-8 x max(1, max|plain|)
ATTN_REL = 2.0 ** -8
#: logits of the 2-layer model, kernels vs plain versions, bfloat16: the
#: runs differ only where the two attentions round to different bfloat16
#: neighbours (1 ulp, 2^-8 relative); two layers and the bfloat16 logit
#: product carry that to a few ulps of the largest logit: bound 4 ulps,
#: 2^-5 x max|logit|
LOGIT_REL = 2.0 ** -5
#: ssd_scan vs plain version in float32 on the same inputs, times
#: max(1, max|plain|): float32 sums in another order (1e-4, the JAX ssd
#: tests' bound); a bfloat16 y is rounded once more (2^-9 relative), bound
#: 2^-8; the final state is float32 in both runs (1e-4)
SSD_REL = {"float32": 1e-4, "bfloat16": 2.0 ** -8}

KERNELS = ("psdsf_fill", "psdsf_fill_bucketed", "psdsf_vds",
           "flash_attention", "decode_attention", "ssd_scan")


#: per-body launch counts beside ``.launches`` (flash_attention's two)
BODY_COUNTS = ("hopper_launches", "cuda_core_launches")


#: Jacobi rounds of the scheduler phase's solves (``schedule_detail`` and
#: ``admitted_rates`` keep ``ensure_converged`` on: a budget the fleet
#: does not converge in raises, and is raised here, never caught)
SCHED_ROUNDS = 32


def cold_route_totals(src, demands, capacities, weights, eligibility,
                      mechanism):
    """Process-pool worker of the lexmm phase: the one-shot cold router's
    per-user totals, stages and wall (s) on the given problem."""
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.core.baselines_torch import level_rate_matrix_np
    from repro_torch.core.flowrouter import lexmm_route_cold_np
    from repro_torch.core.types import AllocationProblem
    prob = AllocationProblem(demands, capacities, weights, eligibility)
    t0 = time.perf_counter()
    x, stages = lexmm_route_cold_np(prob,
                                    level_rate_matrix_np(prob, mechanism))
    return x.sum(axis=1), stages, time.perf_counter() - t0


def reset_counts(counters):
    """Every wrapper's launch counts, its bodies' too, set to 0."""
    for fn in counters.values():
        fn.launches = 0
        for attr in BODY_COUNTS:
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def wrappers():
    """Each kernel's wrapper, which counts its launches in ``.launches``."""
    from repro_torch.kernels.decode_attention import kernel as decode
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.psdsf_fill import kernel as fill
    from repro_torch.kernels.psdsf_fill_bucketed import kernel as bucketed
    from repro_torch.kernels.psdsf_vds import kernel as vds
    from repro_torch.kernels.ssd_scan import kernel as ssd
    return {"psdsf_fill": fill.fill_event_levels,
            "psdsf_fill_bucketed": bucketed.fill_event_levels_bucketed,
            "psdsf_vds": vds.vds_argmin,
            "flash_attention": flash.flash_attention,
            "decode_attention": decode.decode_attention,
            "ssd_scan": ssd.ssd_scan}


class Smoke:
    """Runs the phases, records failures, and collects the kernel rows."""

    def __init__(self, rehearse: bool):
        import torch
        self.torch = torch
        self.rehearse = rehearse
        self.device = torch.device("cpu" if rehearse else "cuda")
        # float32 comparisons in full float32, stated, not left to defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.failed = []
        self.rows = {}
        self.paths = {}

    # -- helpers -----------------------------------------------------------
    def phase(self, name, fn):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:                       # report, go on, fail at end
            traceback.print_exc(file=sys.stdout)
            self.failed.append(name)
            print(f"== {name}: FAILED", flush=True)
            return
        print(f"== {name}: ok ({time.perf_counter() - t0:.2f} s)", flush=True)

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def time_ms(self, fn, iters, graph=False):
        """Mean milliseconds of ``fn`` over ``iters`` warm calls: CUDA
        events around back-to-back calls, or (``graph``) around a replay of
        one CUDA graph of the ``iters`` calls, which leaves out the host's
        time to launch them (a kernel shorter than its Python call is
        otherwise timed at the host's pace); host clock in a rehearsal."""
        torch = self.torch
        for _ in range(2):
            fn()
        self.sync()
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if graph:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(iters):
                    fn()
            g.replay()
            torch.cuda.synchronize()
            start.record()
            g.replay()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def timed(self, fn, iters):
        """(graph-replay ms, back-to-back ms) of ``fn``: see ``time_ms``."""
        return (self.time_ms(fn, iters, graph=True),
                self.time_ms(fn, iters))

    def interleaved(self, kernel_fn, library_fn, iters):
        """Kernel and library call timed in turns, kernel, library, library,
        kernel (graph replays): the readings of each, in that order."""
        k1 = self.time_ms(kernel_fn, iters, graph=True)
        l1 = self.time_ms(library_fn, iters, graph=True)
        l2 = self.time_ms(library_fn, iters, graph=True)
        k2 = self.time_ms(kernel_fn, iters, graph=True)
        return [k1, k2], [l1, l2]

    def check(self, cond, what):
        if not cond:
            raise AssertionError(what)

    # -- inputs ------------------------------------------------------------
    def sizes(self):
        if self.rehearse:
            return dict(n=300, k=32, cells=4, k_big=64, cells_big=8)
        return dict(n=20000, k=256, cells=16, k_big=1024, cells_big=64)

    def event_inputs(self, prob, g, dtype, seed=7):
        """One saturation event's inputs over the whole cluster, as
        ``ops.fill_cluster`` builds them mid-loop: some users frozen, some
        resources saturated, nonzero frozen usage and levels."""
        import numpy as np
        torch = self.torch
        rng = np.random.default_rng(seed)
        n, k = g.shape
        x_ext = rng.uniform(0.0, 2.0, (n, k)) * (g > 0)
        rate = np.where(g > 0, prob.weights[:, None] * g, 0.0)
        floors = np.where(g > 0, x_ext / np.maximum(rate, 1e-300), 0.0)
        active = (g > 0) & (rng.random((n, k)) > 0.2)
        caps = prob.capacities
        arrays = [np.where(active, floors, 0.0), np.where(active, rate, 0.0),
                  prob.demands, caps,
                  rng.uniform(0.0, 0.3, caps.shape) * caps]
        out = [torch.as_tensor(a, dtype=dtype, device=self.device)
               .contiguous() for a in arrays]
        out.append(torch.as_tensor(rng.random(caps.shape) < 0.15,
                                   device=self.device))
        out.append(torch.as_tensor(rng.uniform(0.0, 0.5, k), dtype=dtype,
                                   device=self.device))
        return out

    def bucket_event_inputs(self, prob, g, lay, dtype, seed=7):
        """One bucketed saturation event's inputs, as
        ``ops.fill_cluster_bucketed`` builds them mid-loop on the buckets of
        ``lay``: some slots frozen, padded slots inert, some resources
        saturated, nonzero frozen usage and levels."""
        import numpy as np
        torch = self.torch
        rng = np.random.default_rng(seed)
        n, k = g.shape
        idx, mask = lay.indices, lay.mask
        x_ext = rng.uniform(0.0, 2.0, (n, k))
        gam_b = np.where(mask, np.take_along_axis(g.T, idx, axis=1), 0.0)
        xeb = np.take_along_axis(x_ext.T, idx, axis=1)
        live = mask & (gam_b > 0) & (rng.random(mask.shape) > 0.2)
        rate = np.where(live, prob.weights[idx] * gam_b, 0.0)
        floors = np.where(live, xeb / np.maximum(rate, 1e-300), 0.0)
        caps = prob.capacities
        arrays = [floors, rate, prob.demands[idx], caps,
                  rng.uniform(0.0, 0.3, caps.shape) * caps]
        out = [torch.as_tensor(a, dtype=dtype, device=self.device)
               .contiguous() for a in arrays]
        out.append(torch.as_tensor(rng.random(caps.shape) < 0.15,
                                   device=self.device))
        out.append(torch.as_tensor(rng.uniform(0.0, 0.5, k), dtype=dtype,
                                   device=self.device))
        return out

    @staticmethod
    def bound(nbytes, flops, label):
        """(bound ms, what bounds it): the larger of the bytes over the
        memory rate and the operations over the peak rate of ``label``."""
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = flops / PEAK_FLOPS[label]
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes > t_ops else "operations")

    def compare_event(self, got, want, label, what):
        """Max |kernel - plain| over an event's four outputs, each held to
        1e-9 (float64) or 5e-6 (float32) times max(1, |plain|)."""
        torch = self.torch
        err, ok = 0.0, True
        for name, a, b in zip(("level", "usage", "local_slope", "slope"),
                              got, want):
            e = float((a - b).abs().max())
            scale = max(1.0, float(b.abs().max()))
            bound = F64_ATOL * scale if a.dtype == torch.float64 \
                else F32_REL * scale
            ok &= e <= bound
            err = max(err, e)
            print(f"  {label} {name}: max|kernel-plain|={e:.3e} "
                  f"(bound {bound:.1e})")
        self.check(ok, f"{what} {label} disagrees with plain")
        return err

    # -- phases ------------------------------------------------------------
    def card(self):
        torch = self.torch
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}")
        if self.rehearse:
            self.smi = "(rehearsal: no card)"
            return
        self.smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        print(f"card: {torch.cuda.get_device_name(0)}; "
              f"devices: {torch.cuda.device_count()}")
        print(f"nvidia-smi: {self.smi}")

    def build(self):
        from repro_torch.kernels import _build
        if self.rehearse:
            print("rehearsal: nothing built")
            return
        t0 = time.perf_counter()
        logs = _build.build(list(KERNELS))
        print(f"built {sorted(logs) or 'nothing (cached)'} in "
              f"{time.perf_counter() - t0:.1f} s")
        for name, log in logs.items():
            lines = log.splitlines()
            entries = sum("Compiling entry function" in ln for ln in lines)
            if entries > 16:
                # one line per source of many instances (the bucketed fill's
                # dtype x R x slots), and every one that spills
                regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                        if "registers" in ln and "Used " in ln]
                print(f"  {name}: {entries} kernels, {min(regs)}-"
                      f"{max(regs)} registers a thread")
            entry = ""
            for line in lines:
                if "Compiling entry function" in line:
                    entry = line.split("'")[1] if "'" in line else line
                    if entries <= 16:
                        print(f"  {name}: {entry[:100]}")
                elif entries <= 16 and ("registers" in line
                                        or "spill" in line):
                    print(f"  {name}: {line.strip()}")
                elif "spill" in line and " 0 bytes spill stores" not in line:
                    print(f"  {name}: {entry[-60:]}: {line.strip()}")

    def paper(self):
        import numpy as np
        from repro_torch.core import engine
        from repro_torch.core.instances import fig1_instance, fig2_instance
        want = {("fig1", "psdsf-rdm"): [3, 3, 6],
                ("fig1", "psdsf-tdm"): [3, 3, 6],
                ("fig2", "psdsf-rdm"): [3.6, 3.6, 8, 8],
                ("fig2", "psdsf-tdm"): [3, 3, 6, 6]}
        probs = {"fig1": fig1_instance(), "fig2": fig2_instance()}
        for (name, mech), values in want.items():
            alloc, info = engine.solve(probs[name], mech, device=self.device,
                                       fill="bisect", round="jacobi",
                                       tol=1e-10, max_rounds=512)
            err = float(np.abs(alloc.tasks_per_user - values).max())
            print(f"{name} {mech}: x={np.round(alloc.tasks_per_user, 9)} "
                  f"rounds={info.rounds} converged={info.converged} "
                  f"err={err:.2e}")
            self.check(err <= 1e-6 and info.converged,
                       f"{name} {mech} misses the paper's values")

    def fill_vs_plain(self):
        torch = self.torch
        from repro_torch.core.gamma import gamma_matrix
        from repro_torch.core.instances import sparse_cell_instance
        from repro_torch.kernels.psdsf_fill import kernel, ref
        s = self.sizes()
        prob, _ = sparse_cell_instance(num_users=s["n"], num_servers=s["k"],
                                       cells=s["cells"])
        big, _ = sparse_cell_instance(num_users=s["n"],
                                      num_servers=s["k_big"],
                                      cells=s["cells_big"])
        self.pin, self.big = prob, big
        self.pin_gamma, self.big_gamma = gamma_matrix(prob), gamma_matrix(big)
        cases = (("float64", prob, self.pin_gamma, torch.float64, 48),
                 ("float32", big, self.big_gamma, torch.float32, 26))
        for label, p, g, dtype, steps in cases:
            args = self.event_inputs(p, g, dtype)
            got = kernel.fill_event_levels(*args, steps=steps)
            want = ref.fill_event_levels(*args, steps=steps)
            self.sync()
            err = self.compare_event(got, want, label, "psdsf_fill")
            n, k = g.shape
            r = p.num_resources
            b = 8 if dtype == torch.float64 else 4
            nbytes = (2 * n * k + n * r + 2 * k * r + k) * b + k * r \
                + (k + 3 * k * r) * b
            # every pass over the entries that can move a usage: an entry
            # of rate 0 adds exactly 0 to every sum
            nnz = int((args[1] > 0).sum())
            flops = (steps + 3) * nnz * (2 * r + 3)
            bound_ms, bound_by = self.bound(nbytes, flops, label)
            ms, eager_ms = self.timed(lambda: kernel.fill_event_levels(
                *args, steps=steps), 10)
            plain_ms = self.time_ms(lambda: ref.fill_event_levels(
                *args, steps=steps), 3)
            print(f"  {label} {n}x{k} R={r} steps={steps}: kernel {ms:.4f} ms"
                  f" ({eager_ms:.4f} ms back to back), plain {plain_ms:.3f} "
                  f"ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.3f} GFLOP over the {nnz} entries of rate "
                  f"> 0: bound by {bound_by})")
            self.rows[("psdsf_fill", label)] = dict(
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                shape=f"{n}x{k}x{r}")

    def bucketed_vs_plain(self):
        torch = self.torch
        from repro_torch.core.layout import BucketedLayout
        from repro_torch.kernels.psdsf_fill_bucketed import kernel, ref
        layouts = {}
        for name, g in (("pin", self.pin_gamma), ("big", self.big_gamma)):
            t0 = time.perf_counter()
            layouts[name] = BucketedLayout.from_support(g > 0)
            lay = layouts[name]
            print(f"  BucketedLayout.from_support {g.shape[0]}x{g.shape[1]}:"
                  f" {(time.perf_counter() - t0) * 1e3:.1f} ms host, Bmax "
                  f"{lay.bucket_max}, nnz {lay.nnz}, density "
                  f"{lay.density:.4f}")
        self.pin_layout, self.big_layout = layouts["pin"], layouts["big"]
        cases = (("float64", self.pin, self.pin_gamma, self.pin_layout,
                  torch.float64, 48),
                 ("float32", self.big, self.big_gamma, self.big_layout,
                  torch.float32, 26))
        for label, p, g, lay, dtype, steps in cases:
            args = self.bucket_event_inputs(p, g, lay, dtype)
            got = kernel.fill_event_levels_bucketed(*args, steps=steps)
            want = ref.fill_event_levels_bucketed(*args, steps=steps)
            self.sync()
            err = self.compare_event(got, want, label, "psdsf_fill_bucketed")
            k, bmax = lay.indices.shape
            r = p.num_resources
            b = 8 if dtype == torch.float64 else 4
            # the padded (K, Bmax) buckets read once, outputs written once
            nbytes = (k * bmax * (r + 2) + 2 * k * r + k) * b + k * r \
                + (k + 3 * k * r) * b
            flops = (steps + 3) * k * bmax * (2 * r + 3)
            bound_ms, bound_by = self.bound(nbytes, flops, label)
            ms, eager_ms = self.timed(
                lambda: kernel.fill_event_levels_bucketed(*args, steps=steps),
                50)
            plain_ms = self.time_ms(lambda: ref.fill_event_levels_bucketed(
                *args, steps=steps), 5)
            how = kernel.plan(bmax, r, dtype, steps)
            print(f"  {label} buckets {k}x{bmax} R={r} steps={steps}: kernel "
                  f"{ms:.4f} ms ({eager_ms:.4f} ms back to back), plain "
                  f"{plain_ms:.3f} ms, bound "
                  f"{bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e6:.1f} MFLOP: bound by {bound_by}); plan: "
                  f"{how['threads']} threads, {how['slots']} slots a thread, "
                  f"{how['passes']} passes an event ({how['path']})")
            self.rows[("psdsf_fill_bucketed", label)] = dict(
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err,
                shape=f"{k}x{bmax}x{r}", plan=how)
            self.bucketed_plans(label, args, want, got, steps)

    def bucketed_plans(self, label, args, want, first, steps):
        """The bucketed kernel's three paths on one event (registers, shared
        memory, streamed), forced through the wrapper's thresholds: each
        must give the default plan's bits and hold the plain version, and
        each is timed (graph replays)."""
        if self.rehearse:
            print("  rehearsal: no card, no path timings")
            return
        torch = self.torch
        from repro_torch.kernels.psdsf_fill_bucketed import kernel
        paths = {"registers": (kernel.REG_SLOTS, kernel.SMEM_STAGE_MAX),
                 "shared": ((), kernel.SMEM_STAGE_MAX), "streamed": ((), 0)}
        table = {}
        for path, (reg, smem) in paths.items():
            with mock.patch.object(kernel, "REG_SLOTS", reg), \
                    mock.patch.object(kernel, "SMEM_STAGE_MAX", smem):
                def run():
                    return kernel.fill_event_levels_bucketed(*args,
                                                             steps=steps)
                got = run()
                self.sync()
                self.check(all(torch.equal(a, b) for a, b in zip(got, first)),
                           f"bucketed {label} {path} differs from the "
                           f"default plan")
                err = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
                ms = self.time_ms(run, 20, graph=True)
            table[path] = ms
            print(f"    {label} {path}: {ms:.4f} ms, max|kernel-plain|="
                  f"{err:.3e}, bits equal to the default plan's")
        self.paths.setdefault("bucketed_plans", {})[label] = table

    def vds_vs_plain(self):
        import numpy as np
        torch = self.torch
        from repro_torch.kernels.psdsf_vds import kernel, ref
        g = torch.as_tensor(self.pin_gamma, dtype=torch.float32,
                            device=self.device).contiguous()
        n, k = g.shape
        rng = np.random.default_rng(11)
        xo = torch.as_tensor(rng.uniform(0.0, 10.0, n), dtype=torch.float32,
                             device=self.device)
        mn, arg = kernel.vds_argmin(xo, g)
        pmn, parg = ref.vds_argmin(xo, g)
        self.sync()
        err = self.compare_vds((mn, arg), (pmn, parg), "pin gamma")
        snorm = ref.masked_snorm(xo, g)
        ms, eager_ms = self.timed(lambda: kernel.vds_argmin(xo, g), 50)
        plain_ms = self.time_ms(lambda: ref.vds_argmin(xo, g), 10)
        library_ms = self.time_ms(lambda: torch.min(snorm, dim=0), 50,
                                  graph=True)
        nbytes = n * k * 4 + n * 4 + k * 8
        bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                       2 * n * k / PEAK_FLOPS["float32"]) * 1e3
        print(f"  vds {n}x{k}: kernel {ms:.4f} ms ({eager_ms:.4f} ms back "
              f"to back), plain {plain_ms:.4f} ms, "
              f"torch.min(snorm, dim=0) {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB)")
        self.rows[("psdsf_vds", "float32")] = dict(
            ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes", max_abs_err=err, library_ms=library_ms,
            shape=f"{n}x{k}")
        if self.rehearse:
            print("  rehearsal: no card, no grid")
            return
        big = torch.as_tensor(self.big_gamma, dtype=torch.float32,
                              device=self.device).contiguous()
        xo_big = torch.as_tensor(rng.uniform(0.0, 10.0, big.shape[0]),
                                 dtype=torch.float32, device=self.device)
        sms = kernel._sm_count(self.device)
        for gx, xg in ((g, xo), (big, xo_big)):
            n_, k_ = gx.shape
            shape = f"{n_}x{k_}"
            self.compare_vds(kernel.vds_argmin(xg, gx), ref.vds_argmin(xg, gx),
                             f"{shape} gamma")
            t = self.time_ms(lambda: kernel.vds_argmin(xg, gx), 50,
                             graph=True)
            # the merge alone, on the slabs' partials of the plain version
            grid = kernel.grid(n_, k_, sms)
            rows = grid["rows"]
            starts = range(0, n_, rows)
            parts = [ref.vds_argmin(xg[r0:r0 + rows], gx[r0:r0 + rows])
                     for r0 in starts]
            pmin = torch.stack([p[0] for p in parts]).contiguous()
            parg = torch.stack([p[1] + r0 for p, r0 in zip(parts, starts)])
            parg = parg.to(torch.int32).contiguous()
            self.compare_vds(kernel.merge_slabs(pmin, parg),
                             ref.vds_argmin(xg, gx), f"{shape} merge alone")
            merge_ms = self.time_ms(lambda: kernel.merge_slabs(pmin, parg),
                                    50, graph=True)
            print(f"    {shape}: grid {grid['tiles']} column tiles x "
                  f"{grid['slabs']} slabs of {grid['rows']} rows on {sms} "
                  f"SMs: {t:.4f} ms, the merge kernel alone {merge_ms:.4f} ms")
            self.paths.setdefault("vds_grid", {})[shape] = dict(
                grid, ms=t, merge_ms=merge_ms)
            if gx is g:
                self.rows[("psdsf_vds", "float32")].update(
                    grid=grid, merge_ms=merge_ms)

    def compare_vds(self, got, want, what):
        mn, arg = got
        pmn, parg = want
        self.check(bool((arg == parg).all()), f"VDS argmin differs ({what})")
        err = float((mn - pmn).abs().max())
        rel = float(((mn - pmn).abs() / pmn.abs().clamp(min=1e-30)).max())
        print(f"  vds {what}: argmin equal, max|kernel-plain|={err:.3e} "
              f"rel={rel:.2e}")
        self.check(rel <= VDS_RTOL, f"VDS minimum differs ({what})")
        return err

    def drive(self, layout):
        """Drive one main path with every launch count set to 0 just
        before it and read just after: ``"dense"`` pins the layout, and
        ``"bucketed"`` calls ``engine.solve`` at its default layout, which
        must resolve to the buckets. Then checks what came out."""
        import numpy as np
        torch = self.torch
        from repro_torch.core import engine
        from repro_torch.core.dynamic import min_vds_guarded
        from repro_torch.core.layout import BucketedLayout
        from repro_torch.core.psdsf_torch import psdsf_solve_torch
        counters = wrappers()
        sparse = layout == "bucketed"
        expect = ("psdsf_fill_bucketed" if sparse else "psdsf_fill",
                  "psdsf_vds")
        pin, big = self.pin, self.big
        active_pin = np.ones(pin.num_users, dtype=bool)
        active_big = np.ones(big.num_users, dtype=bool)
        big32 = [a.astype(np.float32) for a in (
            big.demands, big.capacities, big.weights, self.big_gamma)]

        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        reset_counts(counters)
        self.sync()
        t0 = time.perf_counter()
        alloc, info = engine.solve(pin, "psdsf-rdm", device=self.device,
                                   fill="bisect", round="jacobi",
                                   max_rounds=32, tol=0.0,
                                   **({} if sparse else {"layout": "dense"}))
        t_f64 = time.perf_counter() - t0
        f64_launches = {name: fn.launches for name, fn in counters.items()}
        vds_pin = min_vds_guarded(alloc.x, pin.weights, self.pin_gamma,
                                  active_pin, device=self.device)
        t_layout = 0.0
        big_kw = {"layout": "dense"}
        if sparse:
            t0 = time.perf_counter()
            lay = BucketedLayout.from_support(self.big_gamma > 0)
            t_layout = time.perf_counter() - t0
            big_kw = {"layout": "bucketed",
                      "buckets": (lay.indices, lay.mask)}
        self.sync()
        t0 = time.perf_counter()
        x32, rounds32, resid32 = psdsf_solve_torch(
            *big32, mode="rdm", max_rounds=32, tol=1e-6, fill="bisect",
            round="jacobi", device=self.device, **big_kw)
        self.sync()
        t_f32 = time.perf_counter() - t0
        vds_big = min_vds_guarded(x32, big.weights, self.big_gamma,
                                  active_big, device=self.device)
        self.sync()
        launches = {name: fn.launches for name, fn in counters.items()}

        n, k = pin.num_users, pin.num_servers
        print(f"  f64 {n}x{k} engine.solve: {t_f64:.3f} s wall, layout="
              f"{info.layout}, bucket_max={info.bucket_max}, rounds="
              f"{info.rounds}, residual={info.residual:.3e}, stranded="
              f"{info.stranded_frac:.4f}, launches {f64_launches}")
        print(f"  f32 {big.num_users}x{big.num_servers} psdsf_solve_torch "
              f"({big_kw['layout']}): {t_f32:.3f} s wall"
              + (f" (+ {t_layout:.3f} s host layout build)" if sparse else "")
              + f", rounds={rounds32}, residual={float(resid32):.3e}")
        print(f"  launches on the {layout} main path: {launches}")
        peak = None
        if self.device.type == "cuda":
            peak = torch.cuda.max_memory_allocated() / 2**30
            print(f"  peak device memory: {peak:.2f} GiB")
        self.paths[layout] = dict(
            launches=launches, f64_s=t_f64, f64_rounds=info.rounds,
            f64_resid=info.residual, f32_s=t_f32, f32_rounds=rounds32,
            f32_resid=float(resid32), f32_layout_build_s=t_layout,
            peak_gib=peak)

        self.check(info.layout == layout, f"engine.solve ran {info.layout}")
        if sparse:
            want_bmax = self.pin_layout.bucket_max
            self.check(info.bucket_max == want_bmax and (
                self.rehearse or want_bmax == 692),
                f"bucket_max {info.bucket_max}, expected 692")
        if not self.rehearse:
            for name, count in launches.items():
                if name in expect:
                    self.check(count > 0, f"{name} never launched on the "
                                          f"{layout} path")
                else:
                    self.check(count == 0, f"{name} launched on the "
                                           f"{layout} path")
            fill_name = expect[0]
            self.check(f64_launches[fill_name] == 5 * 32,
                       f"{fill_name} launched {f64_launches[fill_name]} "
                       f"times in the f64 solve, expected 5 x 32")

        # outputs: finite, non-negative, feasible
        for label, p, x in (("f64", pin, alloc.x),
                            ("f32", big, x32.double().cpu().numpy())):
            self.check(x.shape == (p.num_users, p.num_servers), "x shape")
            self.check(bool(np.isfinite(x).all()), f"{label} x not finite")
            self.check(float(x.min()) >= -1e-6, f"{label} x negative")
            usage = np.einsum("nk,nr->kr", x, p.demands)
            over = float((usage - p.capacities).max())
            print(f"  {label}: max(usage - capacity) = {over:.3e}")
            self.check(over <= 1e-5 * p.capacities.max(),
                       f"{label} allocation infeasible")

        # the same float64 solve with the plain fill, on the same device
        from repro_torch.core.psdsf_torch import (_solve_core_bucketed_torch,
                                                  _solve_core_torch)
        from repro_torch.kernels.psdsf_fill.ref import fill_cluster_plain
        from repro_torch.kernels.psdsf_fill_bucketed.ref import \
            fill_cluster_bucketed_plain

        def t(a):
            return torch.as_tensor(a, dtype=torch.float64,
                                   device=self.device).contiguous()
        arrays = (t(pin.demands), t(pin.capacities), t(pin.weights),
                  t(self.pin_gamma), torch.zeros((n, k), dtype=torch.float64,
                                                 device=self.device))
        kw = dict(fill="bisect", round_mode="jacobi")
        if sparse:
            x_plain, r_plain, _ = _solve_core_bucketed_torch(
                *arrays, torch.as_tensor(self.pin_layout.indices,
                                         device=self.device),
                torch.as_tensor(self.pin_layout.mask, device=self.device),
                "rdm", 32, 0.0, cluster_fill=fill_cluster_bucketed_plain,
                **kw)
        else:
            x_plain, r_plain, _ = _solve_core_torch(
                *arrays, "rdm", 32, 0.0, cluster_fill=fill_cluster_plain,
                **kw)
        diff = float(np.abs(x_plain.cpu().numpy() - alloc.x).max())
        print(f"  f64 kernel-driven vs plain-driven {layout} solve: "
              f"max|dx|={diff:.3e} over {r_plain} rounds")
        self.check(r_plain == info.rounds and diff <= F64_ATOL,
                   "kernel-driven and plain-driven solves disagree")
        if sparse:
            diff = float(np.abs(alloc.x - self.x_dense).max())
            print(f"  f64 bucketed vs dense kernel-driven solve: max|dx|="
                  f"{diff:.3e}")
            self.check(diff <= F64_ATOL, "bucketed and dense solves differ")
        else:
            self.x_dense = alloc.x

        from repro_torch.kernels.psdsf_vds.ref import vds_argmin
        for what, got, x, p, g in (
                ("f64 pin", vds_pin, t(alloc.x), pin, self.pin_gamma),
                ("f32 1024", vds_big, x32, big, self.big_gamma)):
            xo = (x.sum(dim=1) / t(p.weights)).float()
            self.compare_vds(got, vds_argmin(xo, torch.as_tensor(
                g, dtype=torch.float32, device=self.device)), what)

    def main_path(self):
        self.drive("dense")

    def sparse_path(self):
        self.drive("bucketed")
        d, b = self.paths["dense"], self.paths["bucketed"]
        print(f"  bucketed vs dense wall: f64 pin engine.solve "
              f"{b['f64_s']:.3f} s vs {d['f64_s']:.3f} s "
              f"({d['f64_s'] / b['f64_s']:.2f}x); f32 1024 solve "
              f"{b['f32_s']:.3f} s vs {d['f32_s']:.3f} s "
              f"({d['f32_s'] / b['f32_s']:.2f}x)")

    def profile(self):
        for layout in ("dense", "bucketed"):
            self.profile_layout(layout)

    def profile_layout(self, layout):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.core import engine
        pin = self.pin
        kernel_name = {"dense": ("psdsf_fill", "fill_event_kernel"),
                       "bucketed": ("psdsf_fill_bucketed",
                                    "fill_bucketed_kernel")}[layout]
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)

        def run(rounds):
            engine.solve(pin, "psdsf-rdm", device=self.device, fill="bisect",
                         round="jacobi", layout=layout, max_rounds=rounds,
                         tol=0.0)
            self.sync()
        with profile(activities=acts):        # the first start is slow
            run(1)
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            run(32)
        wall_ms = (time.perf_counter() - t0) * 1e3
        # kernels only: a kernel's time is not also counted under the
        # CPU-side op that launched it
        rows = sorted(((float(e.self_device_time_total), e.key, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA), reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3
        if busy_ms <= 0:
            print(f"  {layout}: profiler saw no device time: not measured")
            return
        fill_ms = sum(r[0] for r in rows if kernel_name[1] in r[1]) / 1e3
        print(f"  engine.solve f64 {pin.num_users}x{pin.num_servers} "
              f"{layout}, 32 Jacobi rounds, profiled: wall {wall_ms:.1f} ms,"
              f" device busy {busy_ms:.1f} ms ({kernel_name[0]} "
              f"{fill_ms:.1f} ms, other kernels and copies "
              f"{busy_ms - fill_ms:.1f} ms), idle share "
              f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
        for us, key, count in rows[:8]:
            print(f"    {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
        host = sorted(((float(e.self_cpu_time_total), e.key, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU), reverse=True)
        print(f"  {layout} host self time, top 5:")
        for us, key, count in host[:5]:
            print(f"    {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")

    # -- the allocator's consumers: churn loop, tick layer, batched resolve -
    def churn_stream(self, layout, plain=False):
        """The churn phase's stream on the pin: ``ChurnSimulator`` (Jacobi
        rounds, bisect fill, 32 rounds at tol 1e-6, float32) stepped to the
        t = 0 equilibrium, then through ``poisson_churn_events`` (seed 2)
        one batch of simultaneous events at a time, each step timed with
        its telemetry. ``plain`` drives it with the kernels' plain versions
        (no launch). Returns (simulator, records, step walls in s)."""
        import itertools
        from repro_torch.sched import ChurnSimulator, poisson_churn_events
        pin = self.pin
        horizon, rate = (4, 3.0) if self.rehearse else (12, 40.0)
        events = poisson_churn_events(
            pin.num_users, pin.num_servers, horizon=horizon,
            arrival_rate=rate, departure_rate=rate, degrade_rate=0.25,
            seed=2)
        batches = [(0.0, [])] + [(t, list(evs)) for t, evs in
                                 itertools.groupby(events, lambda e: e.time)]
        records, walls = [], []
        with (self.plain_versions() if plain else contextlib.nullcontext()):
            sim = ChurnSimulator(pin, layout=layout, fill="bisect",
                                 round="jacobi", max_rounds=32, tol=1e-6,
                                 device=self.device)
            for t, evs in batches:
                self.sync()
                t0 = time.perf_counter()
                records.append(sim.step(evs, t))
                self.sync()
                walls.append(time.perf_counter() - t0)
        return sim, records, walls

    @staticmethod
    def plain_versions():
        """Every allocator kernel's wrapper swapped for its plain version
        where the ops modules call it, so a path runs with no launch."""
        from repro_torch.kernels.psdsf_fill import ops as fill_ops
        from repro_torch.kernels.psdsf_fill import ref as fill_ref
        from repro_torch.kernels.psdsf_fill_bucketed import ops as b_ops
        from repro_torch.kernels.psdsf_fill_bucketed import ref as b_ref
        from repro_torch.kernels.psdsf_vds import ops as vds_ops
        from repro_torch.kernels.psdsf_vds import ref as vds_ref
        stack = contextlib.ExitStack()
        for module, name, plain in (
                (fill_ops, "fill_event_levels", fill_ref.fill_event_levels),
                (b_ops, "fill_event_levels_bucketed",
                 b_ref.fill_event_levels_bucketed),
                (vds_ops, "vds_argmin", vds_ref.vds_argmin)):
            stack.enter_context(mock.patch.object(module, name, plain))
        return stack

    def check_launches(self, launches, want, what):
        """On the card: each kernel of ``want`` launched exactly that many
        times on the path, every other kernel never (a rehearsal launches
        nothing)."""
        if self.rehearse:
            return
        for name, count in launches.items():
            self.check(count == want.get(name, 0),
                       f"{name} launched {count} times on the {what}, "
                       f"expected {want.get(name, 0)}")

    def compare_streams(self, got, want, what):
        """Two runs of the churn stream: equal rounds and bottleneck servers
        record by record, final x within PATH_F32_REL x max(1, max|x|),
        every record's min_vds within PATH_F32_REL relative."""
        import numpy as np
        (sim_a, rec_a, _), (sim_b, rec_b, _) = got, want
        self.check([r.rounds for r in rec_a] == [r.rounds for r in rec_b],
                   f"{what}: round counts differ")
        self.check([r.bottleneck_server for r in rec_a]
                   == [r.bottleneck_server for r in rec_b],
                   f"{what}: bottleneck servers differ")
        scale = max(1.0, float(np.abs(sim_b.x).max()))
        dx = float(np.abs(sim_a.x - sim_b.x).max())
        vds = max(abs(a.min_vds - b.min_vds) / abs(b.min_vds)
                  for a, b in zip(rec_a, rec_b))
        print(f"  {what}: rounds and bottleneck servers equal over "
              f"{len(rec_a)} records, max|dx|={dx:.3e} (bound "
              f"{PATH_F32_REL * scale:.1e}), min_vds rel {vds:.2e} (bound "
              f"{PATH_F32_REL:.0e})")
        self.check(dx <= PATH_F32_REL * scale and vds <= PATH_F32_REL,
                   f"{what}: x or min_vds out of bounds")

    def churn_path(self):
        """Drive the churn loop at the pin with every count set to 0 just
        before it and read just after; check the launches against the
        rounds, print the ticks, then hold the run against the same stream
        driven with the plain versions and against a dense-layout run."""
        import numpy as np
        counters = wrappers()
        reset_counts(counters)
        run = self.churn_stream("auto")
        launches = {name: fn.launches for name, fn in counters.items()}
        sim, records, walls = run
        rounds = [r.rounds for r in records]
        print(f"  layout={sim.layout}, bucket_max={records[0].bucket_max}, "
              f"{len(records)} records (t = 0 and {len(records) - 1} event "
              f"ticks), rounds {rounds}, launches {launches}")
        self.check(sim.layout == "bucketed", "churn layout='auto' resolved "
                                             f"to {sim.layout}")
        # R = 4 (RDM): five saturation events, one launch each, a round
        self.check_launches(launches, {"psdsf_fill_bucketed": 5 * sum(rounds),
                                       "psdsf_vds": len(records)},
                            "churn path")
        ticks = records[1:]
        solve = np.array([r.solve_ms for r in ticks])
        print(f"  event ticks: solve_ms median {np.median(solve):.1f} max "
              f"{solve.max():.1f}; warm rounds median "
              f"{np.median([r.rounds for r in ticks]):.0f} max "
              f"{max(r.rounds for r in ticks)}; events a tick median "
              f"{np.median([r.n_events for r in ticks]):.0f}; tick wall with "
              f"telemetry median {np.median(walls[1:]) * 1e3:.1f} ms max "
              f"{max(walls[1:]) * 1e3:.1f} ms; t = 0 solve "
              f"{records[0].solve_ms:.1f} ms ({records[0].rounds} rounds)")
        x = sim.x
        self.check(bool(np.isfinite(x).all()) and float(x.min()) >= 0.0,
                   "churn x not finite or negative")
        caps = sim.allocation().problem.capacities      # degrade-scaled
        over = float((np.einsum("nk,nr->kr", x, self.pin.demands)
                      - caps).max())
        print(f"  final allocation: max(usage - capacity) = {over:.3e}")
        # float32 usage sums over a server's ~700 users
        self.check(over <= PATH_F32_REL * caps.max(),
                   "churn allocation infeasible")
        self.check(all(np.isfinite(r.min_vds) for r in records),
                   "churn min_vds not finite")
        self.paths["churn"] = dict(
            launches=launches, records=len(records), rounds=rounds,
            events=[r.n_events for r in records],
            solve_ms=[r.solve_ms for r in records],
            tick_wall_ms=[w * 1e3 for w in walls],
            min_vds=[r.min_vds for r in records],
            bottleneck=[r.bottleneck_server for r in records])
        self.compare_streams(run, self.churn_stream("auto", plain=True),
                             "kernel-driven vs plain-driven churn")
        reset_counts(counters)
        dense = self.churn_stream("dense")
        dense_launches = {name: fn.launches for name, fn in counters.items()}
        d_rounds = [r.rounds for r in dense[1]]
        print(f"  dense layout: launches {dense_launches}, tick wall median "
              f"{np.median(dense[2][1:]) * 1e3:.1f} ms")
        self.check_launches(dense_launches, {"psdsf_fill": 5 * sum(d_rounds),
                                             "psdsf_vds": len(dense[1])},
                            "dense churn path")
        self.paths["churn_dense"] = dict(
            launches=dense_launches, rounds=d_rounds,
            tick_wall_ms=[w * 1e3 for w in dense[2]])
        self.compare_streams(dense, run, "dense vs bucketed churn")
        self.profile_churn_tick(sim)      # after the comparisons: it steps

    def profile_churn_tick(self, sim):
        """One more churn tick of ``sim`` (the events of the stream's seed
        3, first tick) under torch.profiler: wall, device busy, each
        allocator kernel's share, idle share, and the top host ops."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.sched import poisson_churn_events
        pin = self.pin
        rate = 3.0 if self.rehearse else 40.0
        events = poisson_churn_events(pin.num_users, pin.num_servers,
                                      horizon=1, arrival_rate=rate,
                                      departure_rate=rate, degrade_rate=1.0,
                                      seed=3)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):        # the first start is slow
            pass
        self.sync()
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            rec = sim.step(events, 100.0)
            self.sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(float(e.self_device_time_total), e.key, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy_ms = sum(r[0] for r in rows) / 1e3
        if busy_ms <= 0:
            print("  profiled churn tick: the profiler saw no device time: "
                  "not measured")
            return
        share = {name: sum(r[0] for r in rows if key in r[1]) / 1e3
                 for name, key in (("psdsf_fill_bucketed",
                                    "fill_bucketed_kernel"),
                                   ("psdsf_vds", "vds_"))}
        print(f"  profiled churn tick ({len(events)} events, {rec.rounds} "
              f"rounds): wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
              f"({', '.join(f'{k} {v:.2f} ms' for k, v in share.items())}), "
              f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
        for us, key, count in sorted(rows, reverse=True)[:6]:
            print(f"    {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
        host = sorted(((float(e.self_cpu_time_total), e.key, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU), reverse=True)
        for us, key, count in host[:6]:
            print(f"    host {us / 1e3:9.3f} ms {count:6d}x  {key[:80]}")
        self.paths["churn"]["profiled_tick"] = dict(
            wall_ms=wall_ms, busy_ms=busy_ms, kernels_ms=share,
            idle=max(0.0, 1 - busy_ms / wall_ms), rounds=rec.rounds)

    def tick_path(self):
        """Drive ``DistributedPSDSF`` (float32, bisect fill, layout auto) at
        the pin: one full tick, a departure and a tick over that user's
        servers, then ``min_vds`` (one ``psdsf_vds`` launch); hold x and the
        telemetry to the same calls on the CPU."""
        import numpy as np
        from repro_torch.core.dynamic import DistributedPSDSF
        pin = self.pin
        user = 0
        servers = np.nonzero(self.pin_gamma[user] > 0)[0]

        def drive(device):
            sim = DistributedPSDSF(pin, engine="torch", precision="fast",
                                   fill="bisect", layout="auto",
                                   device=device)
            walls = []
            for call in (lambda: sim.tick(),
                         lambda: sim.set_active(user, False),
                         lambda: sim.tick(servers=servers)):
                t0 = time.perf_counter()
                call()
                walls.append(time.perf_counter() - t0)
            return sim, sim.min_vds(), walls

        counters = wrappers()
        reset_counts(counters)
        sim, (mn, arg), walls = drive(self.device)
        launches = {name: fn.launches for name, fn in counters.items()}
        print(f"  layout={sim.layout}, bucket_max={sim.bucket_max}: full "
              f"tick {walls[0]:.3f} s, tick over user {user}'s "
              f"{len(servers)} servers {walls[2]:.3f} s, launches {launches}")
        self.check_launches(launches, {"psdsf_vds": 1}, "tick path")
        self.check(not sim.x[user].any(), "the departed user kept tasks")
        cpu, (mn_c, arg_c), walls_c = drive("cpu")
        scale = max(1.0, float(np.abs(cpu.x).max()))
        dx = float(np.abs(sim.x - cpu.x).max())
        rel = float((np.abs(mn - mn_c) / np.abs(mn_c)).max())
        # an argmin may differ only between users whose normalized VDS lie
        # within the bound: the card's pick, valued on the CPU's x, must
        # attain the CPU's minimum to PATH_F32_REL
        cols = np.arange(pin.num_servers)
        xo = cpu.x.sum(axis=1) / pin.weights
        picked = xo[arg] / self.pin_gamma[arg, cols]
        moved = int((arg != arg_c).sum())
        ties_ok = bool(np.all(picked <= mn_c * (1 + PATH_F32_REL))
                       and cpu.active[arg].all())
        print(f"  card vs CPU: max|dx|={dx:.3e} (bound "
              f"{PATH_F32_REL * scale:.1e}), min_vds rel {rel:.2e}, argmin "
              f"differs on {moved} of {len(arg)} servers, each a tie within "
              f"the bound: {ties_ok}; CPU full tick {walls_c[0]:.3f} s")
        self.check(dx <= PATH_F32_REL * scale and rel <= PATH_F32_REL
                   and ties_ok, "tick path on the card differs from the CPU")
        self.paths["tick"] = dict(launches=launches, full_tick_s=walls[0],
                                  partial_tick_s=walls[2],
                                  cpu_full_tick_s=walls_c[0])

    def batched_path(self):
        """``psdsf_resolve_batched`` over four scenarios of the pin, each
        with one server degraded to 0.5, from the float64 fixed point of
        the main path (bucketed, Jacobi, bisect), counts set to 0 just
        before and read just after; each scenario is held to its own
        unbatched warm-started solve, the same two phases through the
        bucketed core alone."""
        import numpy as np
        torch = self.torch
        from repro_torch.core.batched import (batch_problems,
                                              psdsf_resolve_batched)
        from repro_torch.core.psdsf_torch import _solve_core_bucketed_torch
        from repro_torch.core.types import AllocationProblem
        pin, lay = self.pin, self.pin_layout
        k = pin.num_servers
        degraded = [j * k // 4 for j in range(4)]
        probs, rows = [], []
        for s in degraded:
            caps = pin.capacities.copy()
            caps[s] *= 0.5
            probs.append(AllocationProblem(pin.demands, caps, pin.weights,
                                           pin.eligibility))
            rows.append(np.unique(np.concatenate(
                [[s], lay.servers_of(lay.bucket_users(s))])).astype(np.int32))
        width = max(len(r) for r in rows)
        srv = np.stack([np.pad(r, (0, width - len(r)), mode="edge")
                        for r in rows])
        bat = batch_problems(probs, dtype=np.float64, device=self.device)
        arrays = [bat[key] for key in ("demands", "capacities", "weights",
                                       "gamma")]
        x0 = np.stack([self.x_dense] * len(probs))
        idx = np.stack([lay.indices] * len(probs))
        mask = np.stack([lay.mask] * len(probs))
        kw = dict(max_rounds=16, tol=1e-6, fill="bisect", round="jacobi",
                  layout="bucketed")
        counters = wrappers()
        reset_counts(counters)
        self.sync()
        t0 = time.perf_counter()
        x, r_restr, r_full, resid = psdsf_resolve_batched(
            *arrays, x0, srv, buckets=(idx, mask), device=self.device, **kw)
        self.sync()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        total = int(r_restr.sum() + r_full.sum())
        print(f"  B={len(probs)} scenarios (servers {degraded} at 0.5; "
              f"{srv.shape[1]} servers a restricted sweep): {wall:.3f} s, "
              f"restricted rounds {r_restr.tolist()}, full rounds "
              f"{r_full.tolist()}, residual "
              f"{[f'{float(v):.2e}' for v in resid]}, launches {launches}")
        self.check_launches(launches, {"psdsf_fill_bucketed": 5 * total},
                            "batched re-solve")
        idx_t = torch.as_tensor(lay.indices, device=self.device)
        mask_t = torch.as_tensor(lay.mask, device=self.device)
        worst = 0.0
        for j, row in enumerate(rows):
            d, c, w, g = (a[j] for a in arrays)
            x_init = torch.as_tensor(self.x_dense, device=self.device)
            core = dict(fill="bisect", round_mode="jacobi")
            out1 = _solve_core_bucketed_torch(
                d, c, w, g, x_init, idx_t, mask_t, "rdm", 16, 1e-6,
                servers=row, alpha0=0.3, **core)
            out2 = _solve_core_bucketed_torch(
                d, c, w, g, out1[0], idx_t, mask_t, "rdm", 16, 1e-6,
                alpha0=0.02, **core)
            diff = float((x[j] - out2[0]).abs().max())
            worst = max(worst, diff)
            self.check(out1[1] == int(r_restr[j]) and out2[1] == int(r_full[j])
                       and diff <= F64_ATOL,
                       f"scenario {j} differs from its unbatched solve")
            self.check(bool(torch.isfinite(x[j]).all())
                       and float(x[j].min()) >= 0.0,
                       f"scenario {j} x not finite or negative")
        print(f"  each scenario vs its unbatched warm-started solve: round "
              f"counts equal, max|dx|={worst:.3e} (bound {F64_ATOL:.0e})")
        self.paths["batched"] = dict(
            launches=launches, wall_s=wall, restricted=r_restr.tolist(),
            full=r_full.tolist(), servers_a_sweep=int(srv.shape[1]))

    # -- headroom placement and the baselines --------------------------------
    def profile_window(self, label, fn, keys, host_ops=True):
        """``fn`` under torch.profiler: wall, device busy, the time of each
        kernel of ``keys`` (name -> substring of its CUDA symbol) and the
        idle share; ``None`` when the profiler saw no device time.
        ``host_ops=False`` traces the device alone (a window of ~10^5
        small launches otherwise costs minutes of host-side recording)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        acts = ([ProfilerActivity.CPU]
                if host_ops or self.device.type != "cuda" else [])
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):        # the first start is slow
            pass
        self.sync()
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            fn()
            self.sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(float(e.self_device_time_total), e.key, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy_ms = sum(r[0] for r in rows) / 1e3
        if busy_ms <= 0:
            print(f"  {label}: the profiler saw no device time: not measured")
            return None
        share = {name: sum(r[0] for r in rows if key in r[1]) / 1e3
                 for name, key in keys.items()}
        idle = max(0.0, 1 - busy_ms / wall_ms)
        print(f"  {label}, profiled: wall {wall_ms:.1f} ms, device busy "
              f"{busy_ms:.1f} ms ("
              + ", ".join(f"{k} {v:.2f} ms" for k, v in share.items())
              + f"), idle share {idle:.3f}")
        for us, key, count in sorted(rows, reverse=True)[:5]:
            print(f"    {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
        return dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels_ms=share,
                    idle=idle)

    def check_feasible(self, prob, x, label, rel=1e-9):
        """x finite, non-negative and within the capacities to ``rel`` x
        the largest capacity."""
        import numpy as np
        self.check(x.shape == (prob.num_users, prob.num_servers)
                   and bool(np.isfinite(x).all()) and float(x.min()) >= 0.0,
                   f"{label}: x not finite, negative or misshapen")
        over = float((np.einsum("nk,nr->kr", x, prob.demands)
                      - prob.capacities).max())
        self.check(over <= rel * prob.capacities.max(),
                   f"{label}: allocation infeasible ({over:.3e})")
        return over

    def headroom_path(self):
        """``engine.solve(pin, "psdsf-rdm", placement="headroom")`` in
        float64 on the dense layout (Jacobi rounds of the bisect fill, 32
        at tol=0 for the level solve and each refill), counts set to 0 just
        before and read just after: the level solve, then up to three
        repack passes, each followed by a warm dense refill through
        ``psdsf_fill``. The wall is split into the three by timing the
        module functions the solve calls; the fill launches must be 5 x
        every refill's and the level solve's rounds. Held against the same
        solve with the plain versions patched in (1e-9, equal rounds)."""
        import numpy as np
        from repro_torch.core import engine, placement_torch, psdsf_torch
        pin = self.pin
        kw = dict(placement="headroom", fill="bisect", round="jacobi",
                  layout="dense", max_rounds=32, tol=0.0)

        def timed_calls(plain=False):
            log = {"level": [], "repack": [], "refill": []}

            def wrap(what, fn):
                def run(*a, **k):
                    self.sync()
                    t0 = time.perf_counter()
                    out = fn(*a, **k)
                    self.sync()
                    log[what].append((time.perf_counter() - t0,
                                      out[1] if isinstance(out, tuple)
                                      else None))
                    return out
                return run
            stack = self.plain_versions() if plain else contextlib.ExitStack()
            for module, name, what in (
                    (psdsf_torch, "_solve_core_torch", "level"),
                    (placement_torch, "_repack_core_torch", "repack"),
                    (placement_torch, "_solve_core_torch", "refill")):
                stack.enter_context(mock.patch.object(
                    module, name, wrap(what, getattr(module, name))))
            with stack:
                self.sync()
                t0 = time.perf_counter()
                alloc, info = engine.solve(pin, "psdsf-rdm",
                                           device=self.device, **kw)
                self.sync()
            return alloc, info, time.perf_counter() - t0, log

        counters = wrappers()
        reset_counts(counters)
        alloc, info, wall, log = timed_calls()
        launches = {name: fn.launches for name, fn in counters.items()}
        level_rounds = log["level"][0][1]
        refill_rounds = [r for _, r in log["refill"]]
        split = {what: sum(t for t, _ in calls) for what, calls in
                 log.items()}
        print(f"  f64 {pin.num_users}x{pin.num_servers} headroom "
              f"engine.solve: {wall:.3f} s wall = level solve "
              f"{split['level']:.3f} s ({level_rounds} rounds) + "
              f"{len(log['repack'])} repack passes {split['repack']:.3f} s "
              f"({', '.join(f'{t:.3f}' for t, _ in log['repack'])}) + "
              f"refills {split['refill']:.3f} s (rounds {refill_rounds}); "
              f"kept rounds={info.rounds}, residual={info.residual:.3e}, "
              f"stranded={info.stranded_frac:.5f}, launches {launches}")
        self.check_launches(launches, {"psdsf_fill": 5 * (
            level_rounds + sum(refill_rounds))}, "headroom path")
        over = self.check_feasible(pin, alloc.x, "headroom")
        plain, p_info, p_wall, p_log = timed_calls(plain=True)
        diff = float(np.abs(plain.x - alloc.x).max())
        print(f"  kernel-driven vs plain-driven headroom solve: max|dx|="
              f"{diff:.3e}, rounds {info.rounds} / {p_info.rounds}, refill "
              f"rounds {refill_rounds} / {[r for _, r in p_log['refill']]};"
              f" plain-driven wall {p_wall:.3f} s; max(usage - capacity) "
              f"{over:.3e}")
        self.check(diff <= F64_ATOL and info.rounds == p_info.rounds
                   and [r for _, r in p_log["refill"]] == refill_rounds,
                   "kernel-driven and plain-driven headroom solves disagree")
        level_x = getattr(self, "x_dense", None)
        if level_x is not None:
            print(f"  headroom vs the main path's level solve: max|dx|="
                  f"{float(np.abs(alloc.x - level_x).max()):.3e}, per-user "
                  f"totals moved by up to "
                  f"{float(np.abs(alloc.tasks_per_user - level_x.sum(axis=1)).max()):.3e}"
                  f" (the repack keeps them; the refills re-solve)")
        # one pass and its refill, traced on the device alone, on a 5,000 x
        # 256 cut of the generator: the pin's pass is ~250,000 launches
        from repro_torch.core.gamma import gamma_matrix
        from repro_torch.core.instances import sparse_cell_instance
        torch = self.torch
        cut, _ = sparse_cell_instance(
            num_users=100 if self.rehearse else 5000,
            num_servers=16 if self.rehearse else 256,
            cells=4 if self.rehearse else 16)
        level, _ = engine.solve(cut, "psdsf-rdm", device=self.device,
                                fill="bisect", round="jacobi",
                                layout="dense", max_rounds=32, tol=0.0)
        arrays = [torch.as_tensor(a, device=self.device) for a in (
            cut.demands, cut.capacities, cut.weights, gamma_matrix(cut),
            level.x)]
        resid = torch.zeros((), dtype=torch.float64, device=self.device)
        prof = self.profile_window(
            f"one repack pass and its refill on a {cut.num_users}x"
            f"{cut.num_servers} cut (device trace only)",
            lambda: placement_torch._repack_refill_core_torch(
                *arrays, 32, resid, "rdm", 32, 0.0, passes=1,
                fill="bisect", round_mode="jacobi"),
            {"psdsf_fill": "fill_event_kernel"}, host_ops=False)
        self.paths["headroom"] = dict(
            launches=launches, wall_s=wall,
            split_s=split, level_rounds=level_rounds,
            refill_rounds=refill_rounds, kept_rounds=info.rounds,
            residual=info.residual, stranded=info.stranded_frac,
            plain_wall_s=p_wall, profiled_pass=prof)

    def baseline_path(self):
        """``engine.solve`` for tsf, cdrf and cdrfh at level placement
        (float64, Jacobi rounds of the bisect fill, 32 at tol=0) on the
        pin, on the dense layout and on the buckets, counts set to 0 just
        before each and read just after (5 x 32 launches of the layout's
        fill kernel); each held against the same solve with the plain
        versions patched in (1e-9, equal rounds). Then the routed
        headroom fill of tsf at the pin (no kernel; held against the CPU
        on a 2,000 x 64 cut of the same generator)."""
        import numpy as np
        from repro_torch.core import engine
        from repro_torch.core.instances import sparse_cell_instance
        pin = self.pin
        counters = wrappers()
        runs = {}
        for layout, kernel in (("dense", "psdsf_fill"),
                               ("bucketed", "psdsf_fill_bucketed")):
            for mech in ("tsf", "cdrf", "cdrfh"):
                kw = dict(fill="bisect", round="jacobi", layout=layout,
                          max_rounds=32, tol=0.0, device=self.device)
                reset_counts(counters)
                self.sync()
                t0 = time.perf_counter()
                alloc, info = engine.solve(pin, mech, **kw)
                self.sync()
                wall = time.perf_counter() - t0
                launches = {name: fn.launches
                            for name, fn in counters.items()}
                self.check_launches(launches, {kernel: 5 * info.rounds},
                                    f"{mech} {layout} path")
                with self.plain_versions():
                    plain, p_info = engine.solve(pin, mech, **kw)
                diff = float(np.abs(plain.x - alloc.x).max())
                over = self.check_feasible(pin, alloc.x, f"{mech} {layout}")
                print(f"  {mech} {layout}: {wall:.3f} s wall, rounds "
                      f"{info.rounds}, residual {info.residual:.3e}, "
                      f"bucket_max {info.bucket_max}, stranded "
                      f"{info.stranded_frac:.5f}, {kernel} launches "
                      f"{launches[kernel]}; vs plain-driven max|dx|="
                      f"{diff:.3e}; max(usage - capacity) {over:.3e}")
                self.check(diff <= F64_ATOL and info.rounds == p_info.rounds
                           and info.layout == layout,
                           f"{mech} {layout}: kernel-driven and "
                           f"plain-driven solves disagree")
                runs[f"{mech}_{layout}"] = dict(
                    launches=launches, wall_s=wall, rounds=info.rounds,
                    residual=info.residual)
        reset_counts(counters)
        self.sync()
        t0 = time.perf_counter()
        routed, r_info = engine.solve(pin, "tsf", placement="headroom",
                                      device=self.device)
        self.sync()
        r_wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        self.check_launches(launches, {}, "routed tsf fill")
        over = self.check_feasible(pin, routed.x, "routed tsf", rel=1e-6)
        print(f"  tsf routed headroom fill: {r_wall:.3f} s wall, "
              f"{r_info.rounds} events (at most "
              f"{pin.num_servers * pin.num_resources + pin.num_users + 1}), "
              f"stranded {r_info.stranded_frac:.5f} (level dense "
              f"{runs['tsf_dense']['residual']:.1e} residual), max(usage - "
              f"capacity) {over:.3e}")
        cut, _ = sparse_cell_instance(
            num_users=200 if self.rehearse else 2000,
            num_servers=16 if self.rehearse else 64, cells=4)
        a_dev, i_dev = engine.solve(cut, "tsf", placement="headroom",
                                    device=self.device)
        a_cpu, i_cpu = engine.solve(cut, "tsf", placement="headroom",
                                    device="cpu")
        diff = float(np.abs(a_dev.x - a_cpu.x).max())
        print(f"  routed fill on a {cut.num_users}x{cut.num_servers} cut: "
              f"card vs CPU max|dx|={diff:.3e}, events {i_dev.rounds} / "
              f"{i_cpu.rounds}")
        self.check(diff <= F64_ATOL and i_dev.rounds == i_cpu.rounds,
                   "routed fill: card and CPU disagree")
        runs["tsf_routed"] = dict(launches=launches, wall_s=r_wall,
                                  events=r_info.rounds)
        prof = self.profile_window(
            "tsf level solve, dense, 32 Jacobi rounds",
            lambda: engine.solve(pin, "tsf", fill="bisect", round="jacobi",
                                 layout="dense", max_rounds=32, tol=0.0,
                                 device=self.device),
            {"psdsf_fill": "fill_event_kernel"})
        self.paths["baselines"] = dict(
            launches={name: sum(r["launches"][name] for r in runs.values())
                      for name in counters},
            runs=runs, profiled_tsf_dense=prof)

    def baseline_churn(self):
        """``ChurnSimulator(pin, "tsf")`` (float32, layout auto -> buckets,
        Jacobi rounds of the bisect fill, 32 at tol 1e-6) over t = 0 and
        the first ticks of the churn phase's stream (seed 2), counts set
        to 0 just before and read just after (bucketed launches 5 x the
        rounds, one VDS launch a record); held against the same stream
        with the plain versions patched in: rounds equal, per-user totals
        and min_vds within PATH_F32_REL, bottleneck servers
        equal or tied within it; then one more tick profiled."""
        import itertools
        import numpy as np
        from repro_torch.sched import ChurnSimulator, poisson_churn_events
        pin = self.pin
        horizon, rate = (3, 3.0) if self.rehearse else (4, 40.0)
        events = poisson_churn_events(
            pin.num_users, pin.num_servers, horizon=horizon,
            arrival_rate=rate, departure_rate=rate, degrade_rate=0.25,
            seed=2)
        batches = [(0.0, [])] + [(t, list(evs)) for t, evs in
                                 itertools.groupby(events, lambda e: e.time)]

        def run(plain=False):
            records, walls = [], []
            with (self.plain_versions() if plain
                  else contextlib.nullcontext()):
                sim = ChurnSimulator(pin, mechanism="tsf",
                                     fill="bisect", round="jacobi",
                                     max_rounds=32, tol=1e-6,
                                     device=self.device)
                for t, evs in batches:
                    self.sync()
                    t0 = time.perf_counter()
                    records.append(sim.step(evs, t))
                    self.sync()
                    walls.append(time.perf_counter() - t0)
            return sim, records, walls

        counters = wrappers()
        reset_counts(counters)
        sim, records, walls = run()
        launches = {name: fn.launches for name, fn in counters.items()}
        rounds = [r.rounds for r in records]
        print(f"  tsf churn: layout={sim.layout}, bucket_max="
              f"{records[0].bucket_max}, {len(records)} records, rounds "
              f"{rounds}, events {[r.n_events for r in records]}, solve_ms "
              f"{[round(r.solve_ms, 1) for r in records]}, tick walls "
              f"{[round(w * 1e3, 1) for w in walls]} ms, launches "
              f"{launches}")
        self.check(sim.layout == "bucketed",
                   f"tsf churn layout='auto' resolved to {sim.layout}")
        self.check_launches(launches, {"psdsf_fill_bucketed": 5 * sum(rounds),
                                       "psdsf_vds": len(records)},
                            "tsf churn path")
        self.check(all(np.isfinite(r.min_vds) for r in records),
                   "tsf churn min_vds not finite")
        caps = sim.allocation().problem.capacities
        over = float((np.einsum("nk,nr->kr", sim.x, pin.demands)
                      - caps).max())
        self.check(bool(np.isfinite(sim.x).all()) and sim.x.min() >= 0.0
                   and over <= PATH_F32_REL * caps.max(),
                   "tsf churn allocation infeasible")
        p_sim, p_records, _ = run(plain=True)
        self.check(rounds == [r.rounds for r in p_records],
                   "tsf churn: round counts differ from the plain-driven run")
        # a baseline's level rate is the same on all of a user's servers,
        # so its fixed point pins the per-user totals (the levels) and not
        # the split across servers: float32 ulps drift along the split
        # (the CPU shows it too: this stream in the port vs the JAX
        # reference, both on the CPU, differs by 1.8e-4 per entry and
        # 2.1e-6 in the totals); the totals are held, the split printed
        tot, p_tot = sim.x.sum(axis=1), p_sim.x.sum(axis=1)
        scale = max(1.0, float(np.abs(p_tot).max()))
        dtot = float(np.abs(tot - p_tot).max())
        dx = float(np.abs(sim.x - p_sim.x).max())
        vds = max(abs(a.min_vds - b.min_vds) / abs(b.min_vds)
                  for a, b in zip(records, p_records))
        moved = sum(a.bottleneck_server != b.bottleneck_server
                    for a, b in zip(records, p_records))
        print(f"  kernel-driven vs plain-driven tsf churn: rounds equal, "
              f"per-user totals max|d|={dtot:.3e} (bound "
              f"{PATH_F32_REL * scale:.1e}), per entry max|dx|={dx:.3e} "
              f"(the split, not held), min_vds rel {vds:.2e}, bottleneck "
              f"servers differ on {moved} records (a tie: the global "
              f"minima agree within {PATH_F32_REL:.0e})")
        self.check(dtot <= PATH_F32_REL * scale and vds <= PATH_F32_REL,
                   "tsf churn: per-user totals or min_vds out of bounds")
        more = poisson_churn_events(pin.num_users, pin.num_servers,
                                    horizon=1, arrival_rate=rate,
                                    departure_rate=rate, degrade_rate=1.0,
                                    seed=3)
        prof = self.profile_window(
            "one more tsf churn tick", lambda: sim.step(more, 100.0),
            {"psdsf_fill_bucketed": "fill_bucketed_kernel",
             "psdsf_vds": "vds_"})
        self.paths["baseline_churn"] = dict(
            launches=launches, rounds=rounds,
            events=[r.n_events for r in records],
            solve_ms=[r.solve_ms for r in records],
            tick_wall_ms=[w * 1e3 for w in walls], max_dx=dx,
            max_dtotal=dtot, bottleneck_moved=moved, profiled_tick=prof)

    # -- the host lexmm router and the scheduler layers -----------------------
    def lexmm_path(self):
        """``placement="lexmm"`` on the cut, through its three entries:
        (a) ``engine.solve`` for tsf, cdrfh and cdrf (host LPs, no kernel),
        each held to the one-shot cold router (per-user totals, 1e-6 x
        max(1, max total); the cold routes run in a process pool while
        the rest of the phase runs) and checked feasible; (b)
        ``ChurnSimulator(cut, "tsf", placement="lexmm")`` over t = 0 and 4
        ticks of a seeded stream, counts set to 0 just before and read
        just after (one ``psdsf_vds`` launch a record, nothing else), held
        against the same stream with the plain versions patched in; (c)
        ``DistributedPSDSF(cut).routed_allocation("tsf")`` across a
        departure, an arrival and no change, with its router modes."""
        import concurrent.futures
        import multiprocessing
        import numpy as np
        import scipy
        from repro_torch.core import engine
        from repro_torch.core.baselines_torch import level_rate_matrix_np
        from repro_torch.core.flowrouter import RouterState
        from repro_torch.core.instances import sparse_cell_instance
        # a cut of the pin's generator: a from-scratch cold route of the
        # full pin does not end within a run's time (PERF.md section 4)
        cut, _ = sparse_cell_instance(
            num_users=200 if self.rehearse else 2000,
            num_servers=16 if self.rehearse else 64)
        lp_path = ("direct HiGHS wrapper"
                   if RouterState(cut, level_rate_matrix_np(cut, "tsf"))
                   ._direct is not None else "public linprog")
        print(f"  cut {cut.num_users}x{cut.num_servers}, density "
              f"{float((cut.eligibility > 0).mean()):.4f}; LP path "
              f"{lp_path} (scipy {scipy.__version__})")
        mechs = ("tsf", "cdrfh", "cdrf")
        counters = wrappers()
        solves = {}
        spawn = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                len(mechs), mp_context=spawn) as pool:
            colds = {m: pool.submit(cold_route_totals, str(ROOT / "src"),
                                    cut.demands, cut.capacities, cut.weights,
                                    cut.eligibility, m) for m in mechs}
            reset_counts(counters)
            for m in mechs:
                self.sync()
                t0 = time.perf_counter()
                alloc, info = engine.solve(cut, m, placement="lexmm",
                                           device=self.device)
                self.sync()
                solves[m] = (alloc, info, time.perf_counter() - t0)
            launches = {name: fn.launches for name, fn in counters.items()}
            self.check_launches(launches, {}, "lexmm solves")
            churn = self.lexmm_churn(cut, counters)
            routed = self.lexmm_routed(cut, solves["tsf"][0].x)
            colds = {m: f.result() for m, f in colds.items()}
        runs = {}
        for m in mechs:
            alloc, info, wall = solves[m]
            tot_c, stages_c, cold_s = colds[m]
            tot = alloc.x.sum(axis=1)
            scale = max(1.0, float(np.abs(tot_c).max()))
            d = float(np.abs(tot - tot_c).max())
            over = self.check_feasible(cut, alloc.x, f"lexmm {m}", rel=1e-6)
            print(f"  {m} lexmm: {wall:.3f} s wall, {info.rounds} stages "
                  f"(cold {stages_c}, {cold_s:.1f} s), stranded "
                  f"{info.stranded_frac:.5f}, vs cold per-user totals "
                  f"max|d|={d:.3e} (bound {1e-6 * scale:.1e}), max(usage - "
                  f"capacity) {over:.3e}")
            self.check(info.placement == "lexmm" and info.converged
                       and d <= 1e-6 * scale and info.rounds == stages_c,
                       f"lexmm {m}: warm router disagrees with the cold one")
            runs[m] = dict(wall_s=wall, stages=info.rounds,
                           cold_s=cold_s, max_dtotal=d,
                           stranded=info.stranded_frac)
        self.paths["lexmm"] = dict(
            launches={name: churn["launches"][name] + launches[name]
                      for name in counters},
            lp_path=lp_path, scipy=scipy.__version__, solves=runs,
            churn=churn, routed=routed)

    def lexmm_churn(self, cut, counters):
        """The lexmm churn stream on the cut: t = 0 and 4 ticks of a
        seeded stream through ``ChurnSimulator(cut, "tsf",
        placement="lexmm")``, once with the kernels (counted) and once
        with the plain versions; returns the run's record of it."""
        import itertools
        import numpy as np
        from repro_torch.core.dynamic import min_vds_guarded
        from repro_torch.sched import ChurnSimulator, poisson_churn_events
        arr, dep = (0.5, 1.0) if self.rehearse else (0.5, 3.0)
        events = poisson_churn_events(cut.num_users, cut.num_servers,
                                      horizon=4, arrival_rate=arr,
                                      departure_rate=dep, degrade_rate=0.25,
                                      seed=2)
        batches = [(0.0, [])] + [(t, list(evs)) for t, evs in
                                 itertools.groupby(events, lambda e: e.time)]

        def run(plain=False):
            records, walls, mins = [], [], []
            with (self.plain_versions() if plain
                  else contextlib.nullcontext()):
                sim = ChurnSimulator(cut, mechanism="tsf", placement="lexmm",
                                     device=self.device)
                for t, evs in batches:
                    self.sync()
                    t0 = time.perf_counter()
                    records.append(sim.step(evs, t))
                    self.sync()
                    walls.append(time.perf_counter() - t0)
                    if plain:      # per-server minima, for the tie check
                        mn, _ = min_vds_guarded(sim.x, cut.weights,
                                                sim._gamma(), sim.active,
                                                device=self.device)
                        mins.append(mn.cpu().numpy())
            return sim, records, walls, mins

        reset_counts(counters)
        sim, records, walls, _ = run()
        launches = {name: fn.launches for name, fn in counters.items()}
        for rec, wall in zip(records, walls):
            print(f"    t={rec.time:.0f}: {rec.n_events} events, "
                  f"{rec.rounds} stages, lp_calls {rec.lp_calls}, warm_hits "
                  f"{rec.warm_hits}, warm_fallbacks {rec.warm_fallbacks}, "
                  f"mode {rec.router_mode}, solve_ms {rec.solve_ms:.1f}, "
                  f"tick wall {wall * 1e3:.1f} ms")
        print(f"  lexmm churn launches {launches}")
        self.check_launches(launches, {"psdsf_vds": len(records)},
                            "lexmm churn")
        p_sim, p_records, _, p_mins = run(plain=True)
        fields = ("rounds", "lp_calls", "warm_hits", "warm_fallbacks",
                  "router_mode")
        self.check(all(getattr(a, f) == getattr(b, f) for a, b in
                       zip(records, p_records) for f in fields),
                   "lexmm churn: router fields differ from the plain run")
        tot, p_tot = sim.x.sum(axis=1), p_sim.x.sum(axis=1)
        scale = max(1.0, float(np.abs(p_tot).max()))
        dtot = float(np.abs(tot - p_tot).max())
        vds = max(abs(a.min_vds - b.min_vds) / abs(b.min_vds)
                  for a, b in zip(records, p_records))
        moved = [j for j, (a, b) in enumerate(zip(records, p_records))
                 if a.bottleneck_server != b.bottleneck_server]
        # P7: the card's pick must attain the plain run's minimum
        ties_ok = all(p_mins[j][records[j].bottleneck_server]
                      <= p_records[j].min_vds * (1 + PATH_F32_REL)
                      for j in moved)
        print(f"  kernel-driven vs plain-driven lexmm churn: router fields "
              f"equal, per-user totals max|d|={dtot:.3e} (bound "
              f"{PATH_F32_REL * scale:.1e}), min_vds rel {vds:.2e}, "
              f"bottleneck servers differ on {len(moved)} records, each a "
              f"tie within the bound: {ties_ok}")
        self.check(dtot <= PATH_F32_REL * scale and vds <= PATH_F32_REL
                   and ties_ok, "lexmm churn: out of bounds")
        return dict(launches=launches,
                    stages=[r.rounds for r in records],
                    lp_calls=[r.lp_calls for r in records],
                    warm_hits=[r.warm_hits for r in records],
                    modes=[r.router_mode for r in records],
                    solve_ms=[r.solve_ms for r in records],
                    tick_wall_ms=[w * 1e3 for w in walls],
                    max_dtotal=dtot, bottleneck_moved=len(moved))

    def lexmm_routed(self, cut, x_tsf):
        """``DistributedPSDSF(cut).routed_allocation("tsf")``: all active,
        after a departure, after the same user's return and with no
        change; modes warm, incremental, fallback, verify, the first
        equal to the lexmm solve ``x_tsf``."""
        import numpy as np
        from repro_torch.core.dynamic import DistributedPSDSF
        dyn = DistributedPSDSF(cut, device=self.device)
        user = int(np.argmax(x_tsf.sum(axis=1)))
        modes, xs, walls = [], [], []
        for change in (None, (user, False), (user, True), None):
            if change is not None:
                dyn.set_active(*change)
            t0 = time.perf_counter()
            xs.append(dyn.routed_allocation("tsf").x)
            walls.append(time.perf_counter() - t0)
            st = dyn.router_stats
            modes.append(st.mode)
            print(f"    routed_allocation after {change or 'no change'}: "
                  f"mode {st.mode}, {st.stages} stages, lp_calls "
                  f"{st.lp_calls}, warm_hits {st.warm_hits}, "
                  f"{walls[-1]:.3f} s")
        d_first = float(np.abs(xs[0] - x_tsf).max())
        d_last = float(np.abs(xs[3].sum(axis=1) - xs[0].sum(axis=1)).max())
        self.check(modes == ["warm", "incremental", "fallback", "verify"]
                   and d_first <= F64_ATOL
                   and d_last <= 1e-6 * max(1.0, float(xs[0].max())),
                   f"routed_allocation: modes {modes}, |dx| {d_first:.2e} "
                   f"/ {d_last:.2e}")
        return dict(modes=modes, walls_s=walls)

    def sched_fleets(self):
        """The scheduler phase's seeded fleets, at the scale PERF.md
        section 1 names (about 20,000 tenants on 256 servers; 800 on 32 in
        a rehearsal): 256 ``TPUPod``s of 16 kinds (4 generations x 4 slice
        sizes, HBM a chip by generation, DCN on some), two failed and
        three degraded, and 20,000 ``TenantJob``s allowed on one or two
        kinds, some with an HBM-per-chip floor or a DCN need; 256
        ``ReplicaGroup``s with 4k-128k context windows and 20,000
        ``Tenant``s."""
        import numpy as np
        from repro_torch.sched import (Cluster, ReplicaGroup, Tenant,
                                       TenantJob, TPUPod)
        rng = np.random.default_rng(23)
        n_srv, n_usr = (32, 800) if self.rehearse else (256, 20000)
        hbm = {"v4": 32.0, "v5e": 16.0, "v5p": 95.0, "v6e": 32.0}
        kinds = [(g, c) for g in hbm for c in (16, 64, 128, 256)]
        pods = []
        for i in range(n_srv):
            gen, chips = kinds[i % len(kinds)]
            pods.append(TPUPod(
                f"pod{i}", f"{gen}-{chips}", chips, hbm[gen],
                float(chips * rng.uniform(2.0, 6.0)),
                float(chips * rng.uniform(20.0, 60.0)),
                float(rng.choice([0.0, 25.0, 100.0]))))
        fleet = Cluster(pods)
        for i in rng.choice(n_srv, 5, replace=False)[:2]:
            fleet.mark_failed(f"pod{i}")
        for i in rng.choice(n_srv, 3, replace=False):
            fleet.degrade(f"pod{i}", float(rng.uniform(0.4, 0.9)))
        names = [f"{g}-{c}" for g, c in kinds]
        jobs = []
        for j in range(n_usr):
            chips = float(rng.choice([4.0, 8.0, 16.0]))
            allow = tuple(rng.choice(names, 1 if rng.random() < 0.85 else 2,
                                     replace=False))
            dcn = bool(rng.random() < 0.3)
            jobs.append(TenantJob(
                f"job{j}", float(rng.uniform(0.5, 2.0)), chips,
                chips * float(rng.uniform(4.0, 16.0)),
                chips * float(rng.uniform(1.0, 4.0)),
                chips * float(rng.uniform(5.0, 30.0)),
                float(rng.uniform(1.0, 10.0)) if dcn else 0.0,
                min_hbm_per_chip=float(rng.choice([0.0, 0.0, 24.0, 64.0])),
                generations=allow, needs_dcn=dcn))
        contexts = (4096, 8192, 32768, 131072)
        groups = [ReplicaGroup(
            f"group{i}", float(rng.choice([32, 64, 128, 256])),
            float(rng.uniform(40.0, 640.0)), float(rng.uniform(2e4, 2e5)),
            max_context=int(contexts[i % 4])) for i in range(n_srv)]
        tenants = []
        for t in range(n_usr):
            ctx = int(rng.choice([2048, 4096, 8192, 32768, 131072],
                                 p=[0.3, 0.3, 0.2, 0.15, 0.05]))
            tenants.append(Tenant(
                f"tenant{t}", float(rng.uniform(0.5, 2.0)), ctx,
                ctx / 8192 * float(rng.uniform(0.2, 1.0)),
                float(rng.uniform(256.0, 8192.0))))
        return fleet, jobs, groups, tenants

    def scheduler_path(self):
        """The scheduler layers on the seeded fleets: ``schedule_detail``
        (PS-DSF RDM, float64, Jacobi rounds of the bisect fill,
        ``max_rounds`` ``SCHED_ROUNDS`` at tol 1e-6, ``ensure_converged``
        on) on the dense layout and on the buckets, each with counts set to
        0 just before and read just after ((R+1) launches of the layout's
        fill kernel a round, R = 5) and held against its plain-driven
        twin, dense against bucketed (1e-9, equal rounds), and once at
        ``layout="auto"``; ``admitted_rates`` on the dispatch fleet the
        same way on the dense layout (R = 3); ``DynamicDispatcher``
        (float32, bisect) for full ticks and tenant churn on the card and
        on the CPU, its ``min_vds`` (one ``psdsf_vds`` launch) against the
        plain version; one ``schedule_detail`` profiled."""
        import numpy as np
        from repro_torch.core.layout import BucketedLayout
        from repro_torch.sched import (DynamicDispatcher, admitted_rates,
                                       dispatch_problem, schedule_detail)
        fleet, jobs, groups, tenants = self.sched_fleets()
        prob = fleet.problem(jobs)
        lay = BucketedLayout.from_cluster(fleet, jobs)
        print(f"  cluster {prob.num_users} jobs x {prob.num_servers} pods x "
              f"{prob.num_resources} resources: eligibility density "
              f"{lay.density:.4f}, bucket_max {lay.bucket_max}")
        kw = dict(fill="bisect", round="jacobi", max_rounds=SCHED_ROUNDS,
                  device=self.device)
        kernel = {"dense": "psdsf_fill", "bucketed": "psdsf_fill_bucketed"}
        counters = wrappers()
        total = {name: 0 for name in counters}
        runs = {}
        for layout in ("dense", "bucketed", "auto"):
            reset_counts(counters)
            self.sync()
            t0 = time.perf_counter()
            alloc, info = schedule_detail(fleet, jobs, layout=layout, **kw)
            self.sync()
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counters.items()}
            for name in counters:
                total[name] += launches[name]
            self.check_launches(
                launches, {kernel[info.layout]: (prob.num_resources + 1)
                           * info.rounds}, f"schedule {layout}")
            over = self.check_feasible(prob, alloc.x, f"schedule {layout}")
            print(f"  schedule_detail layout={layout} -> {info.layout}: "
                  f"{wall:.3f} s wall, {info.rounds} rounds, residual "
                  f"{info.residual:.3e} (converged {info.converged}, "
                  f"approx {info.approx}), bucket_max {info.bucket_max}, "
                  f"stranded {info.stranded_frac:.5f}, launches "
                  f"{launches[kernel[info.layout]]}, max(usage - capacity) "
                  f"{over:.3e}")
            runs[layout] = (alloc, info, wall)
            if layout == "auto":
                continue
            with self.plain_versions():
                plain, p_info = schedule_detail(fleet, jobs, layout=layout,
                                                **kw)
            diff = float(np.abs(plain.x - alloc.x).max())
            print(f"    vs plain-driven: max|dx|={diff:.3e}, rounds "
                  f"{p_info.rounds}")
            self.check(diff <= F64_ATOL and p_info.rounds == info.rounds,
                       f"schedule {layout}: kernel and plain runs disagree")
        (d_alloc, d_info, _), (b_alloc, b_info, _) = (runs["dense"],
                                                      runs["bucketed"])
        diff = float(np.abs(d_alloc.x - b_alloc.x).max())
        print(f"  dense vs bucketed: max|dx|={diff:.3e}, rounds "
              f"{d_info.rounds} / {b_info.rounds}")
        self.check(diff <= F64_ATOL and d_info.rounds == b_info.rounds,
                   "schedule: dense and bucketed disagree")
        # admitted_rates on the dispatch fleet, dense
        from repro_torch.core import engine
        dprob = dispatch_problem(groups, tenants)
        print(f"  dispatch {dprob.num_users} tenants x {dprob.num_servers} "
              f"groups: eligibility density "
              f"{float((dprob.eligibility > 0).mean()):.4f}")

        reset_counts(counters)
        self.sync()
        t0 = time.perf_counter()
        out = admitted_rates(groups, tenants, layout="dense", **kw)
        self.sync()
        r_wall = time.perf_counter() - t0
        r_launches = {name: fn.launches for name, fn in counters.items()}
        x_rates = np.array([list(out[t.name].values()) for t in tenants])
        for name in counters:
            total[name] += r_launches[name]
        # the plain-driven twin: the solve admitted_rates makes, with the
        # plain versions patched in (its info gives the rounds)
        with self.plain_versions():
            plain, p_info = engine.solve(dprob, layout="dense", **kw)
        self.check_launches(r_launches, {"psdsf_fill": (dprob.num_resources
                                                        + 1) * p_info.rounds},
                            "admitted_rates")
        self.check_feasible(dprob, x_rates, "admitted_rates")
        diff = float(np.abs(plain.x - x_rates).max())
        print(f"  admitted_rates: {r_wall:.3f} s wall (the solve and "
              f"{x_rates.size} dict entries), {p_info.rounds} rounds, "
              f"residual {p_info.residual:.3e}, launches "
              f"{r_launches['psdsf_fill']}, vs plain-driven "
              f"max|dx|={diff:.3e}")
        self.check(diff <= F64_ATOL, "admitted_rates: kernel and plain "
                                     "runs disagree")

        # DynamicDispatcher: ticks on the card and on the CPU
        churned = [t.name for t in tenants[:: max(1, len(tenants) // 8)]]

        def dispatch(device):
            disp = DynamicDispatcher(groups, tenants, precision="fast",
                                     fill="bisect", device=device)
            walls = []
            for step in range(3):
                if step == 2:
                    for name in churned:
                        disp.set_active(name, False)
                t0 = time.perf_counter()
                disp.tick()
                walls.append(time.perf_counter() - t0)
            return disp, walls

        reset_counts(counters)
        disp, walls = dispatch(self.device)
        mn, arg = disp.sim.min_vds()
        t_launches = {name: fn.launches for name, fn in counters.items()}
        for name in counters:
            total[name] += t_launches[name]
        self.check_launches(t_launches, {"psdsf_vds": 1},
                            "dispatcher ticks")
        with self.plain_versions():
            mn_p, arg_p = disp.sim.min_vds()
        self.check(bool(np.array_equal(mn, mn_p)),
                   "dispatcher min_vds: kernel and plain version differ")
        cpu, c_walls = dispatch("cpu")
        scale = max(1.0, float(np.abs(cpu.sim.x).max()))
        dx = float(np.abs(disp.sim.x - cpu.sim.x).max())
        print(f"  DynamicDispatcher layout={disp.sim.layout}: tick walls "
              f"{[round(w, 3) for w in walls]} s on the card, "
              f"{[round(w, 3) for w in c_walls]} s on the CPU ({len(churned)}"
              f" tenants departed before the third); min_vds equal to its "
              f"plain version; card vs CPU max|dx|={dx:.3e} (bound "
              f"{PATH_F32_REL * scale:.1e})")
        self.check(dx <= PATH_F32_REL * scale,
                   "dispatcher: card and CPU ticks disagree")
        self.check(not disp.sim.x[[t.name for t in tenants].index(
            churned[0])].any(), "a departed tenant kept its quota")
        prof = self.profile_window(
            "schedule_detail, dense", lambda: schedule_detail(
                fleet, jobs, layout="dense", **kw),
            {"psdsf_fill": "fill_event_kernel"})
        self.paths["scheduler"] = dict(
            launches=total, density=lay.density, bucket_max=lay.bucket_max,
            schedule={layout: dict(wall_s=w, rounds=i.rounds,
                                   residual=i.residual, layout=i.layout)
                      for layout, (_, i, w) in runs.items()},
            admitted_rates=dict(wall_s=r_wall, rounds=p_info.rounds,
                                residual=p_info.residual),
            dispatcher=dict(layout=disp.sim.layout, tick_walls_s=walls,
                            cpu_tick_walls_s=c_walls),
            profiled_schedule=prof)

    # -- attention kernels and the serving path -----------------------------
    def llm_config(self, layers=None, arch="qwen3_1_7b"):
        """``arch`` at full width in bfloat16 (its smoke config in a
        rehearsal), optionally cut to ``layers``."""
        from repro_torch.configs import get_config, get_smoke_config
        cfg = (get_smoke_config(arch) if self.rehearse
               else get_config(arch))
        return dataclasses.replace(cfg, num_layers=layers) if layers else cfg

    def attn_inputs(self, shapes, dtype, seed):
        torch = self.torch
        g = torch.Generator(device=self.device).manual_seed(seed)
        return [torch.randn(s, generator=g, device=self.device).to(dtype)
                for s in shapes]

    def compare_attn(self, got, plain32, what):
        """max |kernel - plain| against 2^-8 x max(1, max|plain|)."""
        err = float((got.float() - plain32).abs().max())
        bound = ATTN_REL * max(1.0, float(plain32.abs().max()))
        print(f"  {what}: max|kernel-plain f32|={err:.3e} (bound "
              f"{bound:.3e})")
        self.check(err <= bound, f"{what} disagrees with plain")
        return err

    def flash_vs_plain(self):
        """At S 1,024, a ragged 1,000, 512 (the profiled window's prompts)
        and 128 (the shortest prompt): each held against the plain version
        and timed in turns with SDPA; each call must take the Hopper body."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.flash_attention import kernel, ref
        cfg = self.llm_config()
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        dtype = torch.bfloat16
        lengths = (128, 100, 64, 32) if self.rehearse else (1024, 1000, 512,
                                                             128)
        keys = ("bfloat16", "bfloat16_ragged", "bfloat16_s512",
                "bfloat16_s128")
        for key, s in zip(keys, lengths):
            q, k, v = self.attn_inputs([(1, s, hq, d), (1, s, hkv, d),
                                        (1, s, hkv, d)], dtype, seed=s)
            hopper = kernel.flash_attention.hopper_launches
            got = kernel.flash_attention(q, k, v)
            plain32 = ref.flash_attention(q.float(), k.float(), v.float())
            self.sync()
            err = self.compare_attn(got, plain32, f"flash S={s}")
            if not self.rehearse:
                self.check(kernel.flash_attention.hopper_launches
                           == hopper + 1, f"flash S={s} missed the Hopper "
                                          f"body")
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            ks, ls = self.interleaved(
                lambda: kernel.flash_attention(q, k, v), sdpa, 20)
            ms, library_ms = sum(ks) / 2, sum(ls) / 2
            eager_ms = self.time_ms(lambda: kernel.flash_attention(q, k, v),
                                    20)
            library_eager_ms = self.time_ms(sdpa, 20)
            plain_ms = self.time_ms(lambda: ref.flash_attention(q, k, v), 5)
            nbytes = (2 * hq + 2 * hkv) * s * d * 2
            flops = 4 * hq * d * s * (s + 1) // 2
            t_bytes = nbytes / PEAK_BYTES_PER_S
            t_ops = flops / PEAK_BF16_FLOPS
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes > t_ops else "operations"
            bq = kernel.block_rows(1, s, hq)
            print(f"  flash (1, {s}, {hq}/{hkv}, {d}) bf16 causal, blocks "
                  f"of {bq} rows, kernel and SDPA in turns: kernel {ks[0]:.4f}, "
                  f"{ks[1]:.4f} ms, SDPA {ls[0]:.4f}, {ls[1]:.4f} ms (back "
                  f"to back: kernel {eager_ms:.4f}, SDPA "
                  f"{library_eager_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.5f} ms ({nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e9:.3f} GFLOP: bound by {bound_by})")
            self.rows[("flash_attention", key)] = dict(
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                library_ms=library_ms, library_eager_ms=library_eager_ms,
                turns_ms=ks, library_turns_ms=ls, block_rows=bq,
                shape=f"1x{s}x{hq}/{hkv}x{d}")

    def flash_plans(self):
        """The Hopper flash body at both block sizes (query rows a block)
        timed at the serving path's prompt lengths (graph replays), beside
        the one the wrapper picks: the measurement behind
        ``kernel.block_rows``."""
        if self.rehearse:
            print("rehearsal: no card, no plan timings")
            return
        torch = self.torch
        from repro_torch.kernels.flash_attention import kernel, ref
        cfg = self.llm_config()
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        table = {}
        for s in (128, 256, 512, 768, 1024):
            q, k, v = self.attn_inputs([(1, s, hq, d), (1, s, hkv, d),
                                        (1, s, hkv, d)], torch.bfloat16,
                                       seed=s)
            plain32 = ref.flash_attention(q.float(), k.float(), v.float())
            row = {}
            for bq in kernel.BLOCK_ROWS:
                with mock.patch.object(kernel, "block_rows",
                                       lambda b, s_, h, _bq=bq: _bq):
                    self.compare_attn(kernel.flash_attention(q, k, v),
                                      plain32, f"flash S={s} BQ {bq}")
                    row[f"BQ {bq}"] = self.time_ms(
                        lambda: kernel.flash_attention(q, k, v), 20,
                        graph=True)
            chosen = kernel.block_rows(1, s, hq)
            table[s] = dict(row, chosen=f"BQ {chosen}")
            print(f"  S={s}: " + ", ".join(f"{p} {ms:.4f} ms"
                                           for p, ms in row.items())
                  + f"; the wrapper picks BQ {chosen}")
        self.paths["flash_tile_plans"] = table

    def decode_vs_plain(self):
        """The serving shape (8 slots of a 2,048-row cache, one length per
        slot: 1, the whole cache, past the cache, ragged), then one long
        sequence (1 x 32,768 rows), where splitting the rows matters most."""
        cfg = self.llm_config()
        long_rows = 256 if self.rehearse else 32768
        self.decode_case("bfloat16", cfg, 8, 64 if self.rehearse else 2048)
        self.decode_case("bfloat16_long", cfg, 1, long_rows,
                         lens=[long_rows - 3])

    def decode_case(self, key, cfg, b, s_max, lens=None):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.decode_attention import kernel, ref
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        dtype = torch.bfloat16
        q, kc, vc = self.attn_inputs([(b, hq, d), (b, s_max, hkv, d),
                                      (b, s_max, hkv, d)], dtype, seed=3)
        if lens is None:
            lens = [1, s_max, s_max + 37, s_max // 2 + 3, s_max // 4 + 1, 64,
                    3 * s_max // 4 - 5, s_max - 1]
        kv_len = torch.tensor(lens, dtype=torch.int32, device=self.device)
        got = kernel.decode_attention(q, kc, vc, kv_len)
        plain32 = ref.decode_attention(q.float(), kc.float(), vc.float(),
                                       kv_len)
        self.sync()
        err = self.compare_attn(got, plain32, f"decode {b}x{s_max}")
        valid = [min(n, s_max) for n in lens]
        top = max(valid)
        qt = q[:, :, None, :]
        kt, vt = (t[:, :top].transpose(1, 2) for t in (kc, vc))
        mask = (torch.arange(top, device=self.device)[None, :]
                < kv_len.clamp(max=s_max)[:, None])[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

        def kern():
            return kernel.decode_attention(q, kc, vc, kv_len)
        ks, ls = self.interleaved(kern, sdpa, 50)
        ms, library_ms = sum(ks) / 2, sum(ls) / 2
        eager_ms = self.time_ms(kern, 50)
        library_eager_ms = self.time_ms(sdpa, 50)
        plain_ms = self.time_ms(lambda: ref.decode_attention(q, kc, vc,
                                                             kv_len), 10)
        nbytes = 2 * sum(valid) * hkv * d * 2 + 2 * b * hq * d * 2 + b * 4
        flops = 4 * sum(valid) * hq * d
        bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                       flops / PEAK_BF16_FLOPS) * 1e3
        chunk = kernel.chunk_rows(b, s_max, hkv)
        blocks = b * hkv * -(-s_max // chunk)
        print(f"  decode ({b} slots, {s_max} rows, {hq}/{hkv}, {d}) bf16, "
              f"lengths {valid}; {blocks} blocks of {chunk} rows; kernel and "
              f"SDPA on the valid prefix in turns: kernel {ks[0]:.4f}, "
              f"{ks[1]:.4f} ms, SDPA {ls[0]:.4f}, {ls[1]:.4f} ms (back to "
              f"back: kernel {eager_ms:.4f}, SDPA {library_eager_ms:.4f} ms),"
              f" plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({nbytes / 1e6:.2f} MB: bound by bytes)")
        self.rows[("decode_attention", key)] = dict(
            ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes", max_abs_err=err, library_ms=library_ms,
            library_eager_ms=library_eager_ms, turns_ms=ks,
            library_turns_ms=ls, blocks=blocks,
            shape=f"{b}x{s_max}x{hq}/{hkv}x{d}")

    @staticmethod
    def serving_launches(cfg, prefills, steps):
        """Launches the serving path must make: each attention layer one
        ``flash_attention`` per prefill and one ``decode_attention`` per
        step, each mamba layer one ``ssd_scan`` per prefill."""
        pattern = cfg.block_pattern
        kinds = [pattern[i % len(pattern)][0] for i in range(cfg.num_layers)]
        attn, mamba = kinds.count("attn"), kinds.count("mamba")
        return {"flash_attention": attn * prefills,
                "decode_attention": attn * steps,
                "ssd_scan": mamba * prefills}

    def serving(self, arch="qwen3_1_7b", path="serving"):
        """The serving path of ``arch``, counts set to 0 just before ``run``
        and read just after."""
        import gc

        import numpy as np
        torch = self.torch
        from repro_torch.models import model as tmodel
        from repro_torch.serve import ServingEngine
        from repro_torch.serve import engine as engine_mod
        cfg = self.llm_config(arch=arch)
        max_len, (lo, hi), max_new = ((64, (8, 40), 4) if self.rehearse
                                      else (2048, (128, 1024), 32))
        self.params_full = None           # an earlier model's params
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = tmodel.init_params(cfg, 0, device=self.device)
        self.sync()
        n_params = sum(p.numel() for p in params.parameters())
        n_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
        if cfg.has_mixer("attn"):
            widths = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads x "
                      f"{cfg.head_dim}, d_ff {cfg.d_ff}")
        else:
            widths = (f"d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM heads x "
                      f"{cfg.ssm_headdim}, state {cfg.ssm_state}, chunk "
                      f"{cfg.ssm_chunk}")
        print(f"  {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model},"
              f" {widths}, vocab {cfg.vocab_size} (padded "
              f"{cfg.vocab_padded}), {cfg.dtype}: {n_params} params, "
              f"{n_bytes / 1e9:.3f} GB; seeded init "
              f"{time.perf_counter() - t0:.2f} s")
        # warm-up outside the engine (cuBLAS handles, the kernels' loads)
        tmodel.forward_prefill(cfg, params, [[1] * 70], device=self.device)
        tmodel.forward_decode(cfg, params, tmodel.init_caches(
            cfg, 2, 80, device=self.device), [1, 2], 70, device=self.device)
        self.params_full = params

        eng = ServingEngine(cfg, params=params, max_slots=8, max_len=max_len,
                            tenant_weights={"gold": 2.0, "free": 1.0},
                            device=self.device)
        rng = np.random.default_rng(0)
        for i in range(16):
            tenant = "gold" if i % 3 else "free"
            n = int(rng.integers(lo, hi + 1))
            eng.submit(tenant, [int(t) for t in rng.integers(
                0, cfg.vocab_size, n)], max_new_tokens=max_new)
        finite = []

        def watch(fn):
            def call(*a, **k):
                logits, caches = fn(*a, **k)
                finite.append(torch.isfinite(logits).all())
                return logits, caches
            return call
        counters = wrappers()
        with mock.patch.object(engine_mod, "forward_prefill",
                               watch(engine_mod.forward_prefill)), \
                mock.patch.object(engine_mod, "forward_decode",
                                  watch(engine_mod.forward_decode)):
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            reset_counts(counters)
            self.sync()
            t0 = time.perf_counter()
            done = eng.run(max_steps=16 * max_new + 64)
            self.sync()
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counters.items()}
            bodies = {attr: getattr(counters["flash_attention"], attr)
                      for attr in BODY_COUNTS}
        st = eng.stats
        per_tenant = {}
        for r in done:
            per_tenant[r.tenant] = per_tenant.get(r.tenant, 0) \
                + len(r.out_tokens)
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if self.device.type == "cuda" else None)
        print(f"  served {len(done)} requests in {wall:.3f} s: "
              f"{st['prefills']} prefills of {st['prefill_tokens']} tokens "
              f"({st['prefill_s'] * 1e3 / st['prefills']:.2f} ms per request,"
              f" {st['prefill_tokens'] / st['prefill_s']:.0f} tokens/s), "
              f"{st['decode_steps']} decode steps "
              f"({st['decode_s'] * 1e3 / st['decode_steps']:.3f} ms per step, "
              f"{st['decode_tokens'] / st['decode_s']:.1f} tokens/s, "
              f"{st['decode_tokens'] / st['decode_steps']:.2f} active slots "
              f"per step)")
        print(f"  tokens per tenant: {per_tenant}; launches: {launches}; "
              f"flash_attention by body: {bodies}"
              + (f"; peak device memory {peak:.2f} GiB" if peak else ""))
        self.paths[path] = dict(
            launches=launches, flash_bodies=bodies, wall_s=wall,
            requests=len(done),
            prefills=st["prefills"], prefill_tokens=st["prefill_tokens"],
            prefill_ms_per_request=st["prefill_s"] * 1e3 / st["prefills"],
            prefill_tokens_per_s=st["prefill_tokens"] / st["prefill_s"],
            decode_steps=st["decode_steps"],
            decode_step_ms=st["decode_s"] * 1e3 / st["decode_steps"],
            decode_tokens_per_s=st["decode_tokens"] / st["decode_s"],
            tokens_per_tenant=per_tenant, peak_gib=peak)

        self.check(len(done) == 16 and all(
            r.done and len(r.out_tokens) == max_new for r in done),
            "not every request completed")
        self.check(all(0 <= t < cfg.vocab_size for r in done
                       for t in r.out_tokens), "a token id outside the vocab")
        self.check(bool(torch.stack(finite).all()), "non-finite logits")
        if not self.rehearse:
            want = self.serving_launches(cfg, st["prefills"], eng._steps)
            for name, count in launches.items():
                self.check(count == want.get(name, 0),
                           f"{name} launched {count} times on the serving "
                           f"path, expected {want.get(name, 0)}")
            # every prefill's attention took the Hopper (TMA + wgmma) body
            self.check(bodies == {"hopper_launches": want["flash_attention"],
                                  "cuda_core_launches": 0},
                       f"flash_attention bodies {bodies}, expected every "
                       f"launch on the Hopper body")

    def serving_profile(self, arch="qwen3_1_7b", path="serving"):
        """Device busy and idle share over a short serving window: 8
        requests of 512 prompt tokens, 8 new tokens each."""
        import numpy as np
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.serve import ServingEngine
        cfg = self.llm_config(arch=arch)
        prompt = 24 if self.rehearse else 512
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        rng = np.random.default_rng(1)
        eng = ServingEngine(cfg, params=self.params_full, max_slots=8,
                            max_len=prompt + 16,
                            tenant_weights={"gold": 2.0, "free": 1.0},
                            device=self.device)
        for i in range(8):
            eng.submit("gold" if i % 3 else "free", [int(t) for t in rng.integers(
                0, cfg.vocab_size, prompt)], max_new_tokens=8)
        self.sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()       # the run, not the trace's export
            eng.run(max_steps=64)
            self.sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = sorted(((float(e.self_device_time_total), e.key, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA), reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3
        st = eng.stats
        print(f"  profiled window: {st['prefills']} prefills x {prompt} "
              f"tokens, {st['decode_steps']} decode steps: wall "
              f"{wall_ms:.1f} ms (prefill {st['prefill_s'] * 1e3:.1f}, decode"
              f" {st['decode_s'] * 1e3:.1f})")
        if busy_ms <= 0:
            print("  profiler saw no device time: not measured")
            return
        attn = {name: sum(r[0] for r in rows if key in r[1]) / 1e3
                for name, key in (("flash_attention", "flash_"),
                                  ("decode_attention", "decode_"),
                                  ("ssd_scan", "ssd_"))}
        print(f"  device busy {busy_ms:.1f} ms, idle share "
              f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; "
              + ", ".join(f"{name} {ms:.2f} ms" for name, ms in attn.items()))
        for us, key, count in rows[:10]:
            print(f"    {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
        self.paths[path]["profile"] = dict(
            wall_ms=wall_ms, busy_ms=busy_ms,
            idle_share=max(0.0, 1 - busy_ms / wall_ms), **attn)

    def serving_vs_plain(self):
        """A 2-layer full-width model, the kernels' run then the plain
        versions' run, on the same params and tokens."""
        import numpy as np
        torch = self.torch
        from repro_torch.kernels.decode_attention import ref as decode_ref
        from repro_torch.kernels.flash_attention import ref as flash_ref
        from repro_torch.models import attention as attention_mod
        from repro_torch.models import model as tmodel
        cfg = self.llm_config(layers=2)
        params = tmodel.init_params(cfg, 1, device=self.device)
        s, max_len, steps = (20, 32, 4) if self.rehearse else (300, 512, 4)
        rng = np.random.default_rng(2)
        prompt = rng.integers(0, cfg.vocab_size, (2, s))
        feed = rng.integers(0, cfg.vocab_size, (steps, 2))

        def run():
            logits, caches = tmodel.forward_prefill(cfg, params, prompt,
                                                    device=self.device)
            pool = tmodel.init_caches(cfg, 2, max_len, device=self.device)
            for one, kv in zip(pool, caches):
                for key in ("k", "v"):
                    one[key][:, :s] = kv[key]
            out = [logits]
            pos = torch.tensor([s, s + 7], dtype=torch.int32,
                               device=self.device)
            for tok in feed:
                logits, pool = tmodel.forward_decode(
                    cfg, params, pool, tok, pos, device=self.device)
                out.append(logits)
                pos += 1
            self.sync()
            return out

        counters = wrappers()
        reset_counts(counters)
        kern = run()
        kern_launches = {n: fn.launches for n, fn in counters.items()}
        with mock.patch.object(attention_mod, "flash_attention",
                               flash_ref.flash_attention), \
                mock.patch.object(attention_mod, "decode_attention",
                                  lambda q, kc, vc, n: decode_ref.
                                  decode_attention(q[:, 0], kc, vc, n)[:, None]):
            plain = run()
        plain_launches = {n: fn.launches for n, fn in counters.items()}
        print(f"  2-layer {cfg.name} {cfg.dtype}, prompt 2 x {s}, {steps} "
              f"decode steps: launches with kernels {kern_launches}")
        self.paths["serving_vs_plain"] = dict(
            max_abs_err=self.compare_logits(cfg, kern, plain))
        if not self.rehearse:
            self.check(kern_launches["flash_attention"] == 2
                       and kern_launches["decode_attention"] == 2 * steps,
                       f"kernel launches {kern_launches}")
            self.check(plain_launches == kern_launches,
                       "the plain run launched a kernel")

    def compare_logits(self, cfg, kern, plain, argmax=False):
        """Max |kernel-driven - plain-driven| over a run's logits, each step
        held to 2^-5 x max|logit| (and, with ``argmax``, to equal
        argmaxes)."""
        torch = self.torch
        errs = []
        for i, (a, b) in enumerate(zip(kern, plain)):
            # the padded vocab slots read -1e9 in both runs
            a, b = a[:, :cfg.vocab_size], b[:, :cfg.vocab_size]
            err = float((a - b).abs().max())
            bound = LOGIT_REL * float(b.abs().max())
            same = bool((a.argmax(-1) == b.argmax(-1)).all())
            errs.append(err)
            print(f"  {'prefill' if i == 0 else f'decode {i}'} logits: "
                  f"max|kernels-plain|={err:.4e} (bound {bound:.4e}, "
                  f"max|logit| {float(b.abs().max()):.3f}), argmax equal: "
                  f"{same}")
            self.check(bool(torch.isfinite(a).all()) and err <= bound,
                       "kernel-driven and plain-driven logits disagree")
            self.check(same or not argmax,
                       "kernel-driven and plain-driven argmaxes differ")
        return max(errs)

    # -- the SSD kernel and the Mamba-2 serving path -------------------------
    def ssd_vs_plain(self):
        """``ssd_scan`` through ``ops.ssd_chunked``, the main path's call, in
        the main path's layout: x, B and C slices of one (1, S, d_inner +
        2 N) conv output, dt (1, S, H), y written through strides."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.ssd_scan import kernel, ops, ref
        cfg = self.llm_config(arch="mamba2_1_3b")
        h, p, n, q = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, \
            cfg.ssm_chunk
        di = h * p
        s_full, s_ragged, s_half = ((64, 50, 32) if self.rehearse
                                    else (1024, 1000, 512))
        for key, s, dtype in (("bfloat16", s_full, torch.bfloat16),
                              ("bfloat16_ragged", s_ragged, torch.bfloat16),
                              ("bfloat16_s512", s_half, torch.bfloat16),
                              ("float32", s_full, torch.float32)):
            g = torch.Generator(device=self.device).manual_seed(s)

            def randn(*shape):
                return torch.randn(shape, generator=g, device=self.device)
            # the JAX ssd tests' distribution: dt softplus / 2, a in
            # -exp(0.3 N(0, 1)), B and C at 0.5 N(0, 1)
            xbc = randn(1, s, di + 2 * n)
            xbc[..., di:] /= 2
            xbc = xbc.to(dtype)
            x = xbc[..., :di].reshape(1, s, h, p)
            bm, cm = xbc[..., di:di + n], xbc[..., di + n:]
            dt = F.softplus(randn(1, s, h)) / 2
            a = -torch.exp(randn(h) * 0.3)
            y, state = ops.ssd_chunked(x, dt, a, bm, cm, chunk=q)
            y_plain, state_plain = ref.ssd_scan(
                x.transpose(1, 2).float(), dt.transpose(1, 2), a,
                bm.float(), cm.float(), chunk=q)
            self.sync()
            label = "bfloat16" if dtype == torch.bfloat16 else "float32"
            err = float((y.transpose(1, 2).float() - y_plain).abs().max())
            bound = SSD_REL[label] * max(1.0, float(y_plain.abs().max()))
            s_err = float((state - state_plain).abs().max())
            s_bound = SSD_REL["float32"] * max(
                1.0, float(state_plain.abs().max()))
            print(f"  ssd {key} S={s}: y max|kernel-plain f32|={err:.3e} "
                  f"(bound {bound:.3e}), final state {s_err:.3e} (bound "
                  f"{s_bound:.3e})")
            self.check(err <= bound and s_err <= s_bound,
                       f"ssd_scan {key} disagrees with plain")
            ms, eager_ms = self.timed(lambda: ops.ssd_chunked(
                x, dt, a, bm, cm, chunk=q), 20)
            plain_ms = self.time_ms(lambda: ref.ssd_scan(
                x.transpose(1, 2), dt.transpose(1, 2), a, bm, cm, chunk=q),
                3)
            el = 2 if dtype == torch.bfloat16 else 4
            # x, B, C, dt and a read once; y and the final state written
            nbytes = (2 * h * s * p + 2 * s * n) * el + h * s * 4 + h * 4 \
                + h * p * n * 4
            # the operations the function needs, chunk by chunk (the ragged
            # last one at its own length c): the causal C B^T, the same for
            # every head (ngroups = 1), c(c+1) N; per head the causal W x,
            # c(c+1) P, and C state^T and x^T B, 4 c N P
            flops = sum(c * (c + 1) * n + h * (c * (c + 1) * p + 4 * c * n * p)
                        for c in [q] * (s // q) + ([s % q] if s % q else []))
            t_bytes = nbytes / PEAK_BYTES_PER_S
            t_ops = flops / (PEAK_BF16_FLOPS if dtype == torch.bfloat16
                             else PEAK_FLOPS["float32"])
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes > t_ops else "operations"
            print(f"  ssd (1, {s}, {h}, {p}) N {n} chunk {q} {label}: kernel "
                  f"{ms:.4f} ms ({eager_ms:.4f} ms back to back), plain "
                  f"{plain_ms:.4f} ms, library n/a, bound "
                  f"{bound_ms:.5f} ms ({nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e9:.3f} GFLOP: bound by {bound_by})")
            self.rows[("ssd_scan", key)] = dict(
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err, state_max_abs_err=s_err,
                library_ms=None, shape=f"1x{h}x{s}x{p}xN{n}/Q{q}")

    def mamba_vs_plain(self):
        """A 2-layer full-width mamba2 model, the kernel's run then the
        plain version's run, on the same params and tokens."""
        import numpy as np
        from repro_torch.kernels.ssd_scan import ref as ssd_ref
        from repro_torch.models import model as tmodel
        from repro_torch.models import ssm as ssm_mod
        cfg = self.llm_config(layers=2, arch="mamba2_1_3b")
        params = tmodel.init_params(cfg, 1, device=self.device)
        s, steps = (20, 4) if self.rehearse else (300, 4)
        rng = np.random.default_rng(2)
        prompt = rng.integers(0, cfg.vocab_size, (2, s))
        feed = rng.integers(0, cfg.vocab_size, (steps, 2))

        def run():
            logits, caches = tmodel.forward_prefill(cfg, params, prompt,
                                                    device=self.device)
            out = [logits]
            for tok in feed:
                logits, caches = tmodel.forward_decode(
                    cfg, params, caches, tok, s, device=self.device)
                out.append(logits)
            self.sync()
            return out

        def plain_chunked(x, dt, a, b_mat, c_mat, *, chunk, init_state=None):
            y, state = ssd_ref.ssd_scan(x.transpose(1, 2), dt.transpose(1, 2),
                                        a, b_mat, c_mat, chunk=chunk,
                                        init_state=init_state)
            return y.transpose(1, 2), state

        counters = wrappers()
        reset_counts(counters)
        kern = run()
        kern_launches = {n: fn.launches for n, fn in counters.items()}
        with mock.patch.object(ssm_mod, "ssd_chunked", plain_chunked):
            plain = run()
        plain_launches = {n: fn.launches for n, fn in counters.items()}
        print(f"  2-layer {cfg.name} {cfg.dtype}, prompt 2 x {s}, {steps} "
              f"decode steps: launches with the kernel {kern_launches}")
        self.paths["serving_mamba2_vs_plain"] = dict(
            max_abs_err=self.compare_logits(cfg, kern, plain, argmax=True))
        if not self.rehearse:
            self.check(kern_launches == dict(
                self.serving_launches(cfg, 1, steps), psdsf_fill=0,
                psdsf_fill_bucketed=0, psdsf_vds=0),
                f"kernel launches {kern_launches}")
            self.check(plain_launches == kern_launches,
                       "the plain run launched a kernel")

    def report(self):
        kernels = []
        for name, source, replaces, dtype in (
                ("psdsf_fill", "src/repro_torch/kernels/csrc/psdsf_fill.cu",
                 "src/repro/kernels/psdsf_fill/kernel.py:124", "float64"),
                ("psdsf_fill_bucketed",
                 "src/repro_torch/kernels/csrc/psdsf_fill_bucketed.cu",
                 "src/repro/kernels/psdsf_fill_bucketed/kernel.py:131",
                 "float64"),
                ("psdsf_vds", "src/repro_torch/kernels/csrc/psdsf_vds.cu",
                 "src/repro/kernels/psdsf_vds/kernel.py:55", "float32"),
                ("flash_attention",
                 "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention/kernel.py:74",
                 "bfloat16"),
                ("decode_attention",
                 "src/repro_torch/kernels/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention/kernel.py:63",
                 "bfloat16"),
                ("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:67", "bfloat16")):
            main = self.rows[(name, dtype)]
            by_path = {layout: path["launches"][name]
                       for layout, path in self.paths.items()
                       if "launches" in path}
            row = {"name": name, "route": "cuda", "source": source,
                   "replaces": replaces,
                   "launches": sum(by_path.values()),
                   "launches_by_path": by_path,
                   "max_abs_err": main["max_abs_err"], "ms": main["ms"],
                   "plain_ms": main["plain_ms"],
                   "bound_ms": main["bound_ms"],
                   "bound_by": main["bound_by"],
                   "library_ms": main.get("library_ms"),
                   "shape": main["shape"], "dtype": dtype}
            row.update({key: v for key, v in main.items() if key not in row})
            # the other shapes and dtypes the phases measured
            for variant, prefix in (("float32", "f32"),
                                    ("bfloat16_ragged", "ragged"),
                                    ("bfloat16_long", "long"),
                                    ("bfloat16_s512", "s512"),
                                    ("bfloat16_s128", "s128")):
                other = self.rows.get((name, variant))
                if other and variant != dtype:
                    row.update({f"{prefix}_{key}": v
                                for key, v in other.items()})
            kernels.append(row)
        print(json.dumps({"kernels": kernels, "main_paths": self.paths}))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--rehearse", action="store_true",
                        help="run the phases on the CPU at tiny sizes; "
                             "prints no result")
    args = parser.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not args.rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing measured", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print(f"chip_smoke: src/repro_torch not found under {ROOT}; run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2

    smoke = Smoke(args.rehearse)
    smoke.phase("card", smoke.card)
    smoke.phase("build", smoke.build)
    smoke.phase("paper examples", smoke.paper)
    smoke.phase("psdsf_fill vs plain", smoke.fill_vs_plain)
    if "psdsf_fill vs plain" not in smoke.failed:
        smoke.phase("psdsf_fill_bucketed vs plain", smoke.bucketed_vs_plain)
        smoke.phase("psdsf_vds vs plain", smoke.vds_vs_plain)
        smoke.phase("main path", smoke.main_path)
        if not smoke.failed:
            smoke.phase("main path, sparse", smoke.sparse_path)
        smoke.phase("profile", smoke.profile)
        smoke.phase("churn path", smoke.churn_path)
        smoke.phase("tick path", smoke.tick_path)
        if "main path" not in smoke.failed:
            smoke.phase("batched re-solve", smoke.batched_path)
        smoke.phase("headroom path", smoke.headroom_path)
        smoke.phase("baseline path", smoke.baseline_path)
        smoke.phase("baseline churn", smoke.baseline_churn)
        smoke.phase("lexmm path", smoke.lexmm_path)
        smoke.phase("scheduler path", smoke.scheduler_path)
    smoke.phase("flash_attention vs plain", smoke.flash_vs_plain)
    smoke.phase("flash tile plans", smoke.flash_plans)
    smoke.phase("decode_attention vs plain", smoke.decode_vs_plain)
    smoke.phase("serving path", smoke.serving)
    if "serving path" not in smoke.failed:
        smoke.phase("serving profile", smoke.serving_profile)
    smoke.phase("serving path, kernel vs plain", smoke.serving_vs_plain)
    smoke.phase("ssd_scan vs plain", smoke.ssd_vs_plain)
    mamba = ("mamba2_1_3b", "serving_mamba2")
    smoke.phase("serving path, mamba2_1_3b", lambda: smoke.serving(*mamba))
    if "serving path, mamba2_1_3b" not in smoke.failed:
        smoke.phase("serving profile, mamba2_1_3b",
                    lambda: smoke.serving_profile(*mamba))
    smoke.phase("mamba2 serving, kernel vs plain", smoke.mamba_vs_plain)
    if smoke.failed:
        print(f"chip_smoke: FAILED phases: {smoke.failed}", file=sys.stderr)
        return 1
    if args.rehearse:
        print("chip_smoke: rehearsal passed (no result: nothing ran on a "
              "card)")
        return 0
    smoke.report()
    print(smoke.smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
