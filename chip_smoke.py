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
   gamma), and times both with CUDA events (warm, back to back);
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
7. prints the ``kernels`` JSON line, the ``nvidia-smi`` line, and as its
   last line ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero without the last line. Without a CUDA device,
or without the repository's ``src/`` beside it, it fails at once. With
``--rehearse`` it runs every phase on the CPU at tiny sizes through the plain
versions, skips what needs the card, and never prints a result line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: NVIDIA H100 SXM data sheet: HBM3 rate, float32 and float64 rates outside
#: the tensor cores (dense), all at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

F64_ATOL = 1e-9            # float64 parity bound (tests/test_torch_*.py)
F32_REL = 5e-6             # float32 bound, times max(1, |plain|)
VDS_RTOL = 1e-6            # VDS minimum; argmins must be equal


class Smoke:
    """Runs the phases, records failures, and collects the kernel rows."""

    def __init__(self, rehearse: bool):
        import torch
        self.torch = torch
        self.rehearse = rehearse
        self.device = torch.device("cpu" if rehearse else "cuda")
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

    def time_ms(self, fn, iters):
        """Mean milliseconds of ``fn`` over ``iters`` warm calls (CUDA
        events on the card; host clock in a rehearsal)."""
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
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

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
        logs = _build.build(["psdsf_fill", "psdsf_fill_bucketed",
                             "psdsf_vds"])
        print(f"built {sorted(logs) or 'nothing (cached)'} in "
              f"{time.perf_counter() - t0:.1f} s")
        for name, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}")

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
            flops = (steps + 3) * n * k * (2 * r + 3)
            bound_ms, bound_by = self.bound(nbytes, flops, label)
            ms = self.time_ms(lambda: kernel.fill_event_levels(
                *args, steps=steps), 10)
            plain_ms = self.time_ms(lambda: ref.fill_event_levels(
                *args, steps=steps), 3)
            print(f"  {label} {n}x{k} R={r} steps={steps}: kernel {ms:.3f} ms,"
                  f" plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP: "
                  f"bound by {bound_by})")
            self.rows[("psdsf_fill", label)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err, shape=f"{n}x{k}x{r}")

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
            ms = self.time_ms(lambda: kernel.fill_event_levels_bucketed(
                *args, steps=steps), 50)
            plain_ms = self.time_ms(lambda: ref.fill_event_levels_bucketed(
                *args, steps=steps), 5)
            print(f"  {label} buckets {k}x{bmax} R={r} steps={steps}: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                  f"{bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e6:.1f} MFLOP: bound by {bound_by})")
            self.rows[("psdsf_fill_bucketed", label)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err,
                shape=f"{k}x{bmax}x{r}")

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
        ms = self.time_ms(lambda: kernel.vds_argmin(xo, g), 50)
        plain_ms = self.time_ms(lambda: ref.vds_argmin(xo, g), 10)
        library_ms = self.time_ms(lambda: torch.min(snorm, dim=0), 50)
        nbytes = n * k * 4 + n * 4 + k * 8
        bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                       2 * n * k / PEAK_FLOPS["float32"]) * 1e3
        print(f"  vds {n}x{k}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch.min(snorm, dim=0) {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB)")
        self.rows[("psdsf_vds", "float32")] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
            max_abs_err=err, library_ms=library_ms, shape=f"{n}x{k}")

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
        from repro_torch.kernels.psdsf_fill import kernel as fill_kernel
        from repro_torch.kernels.psdsf_fill_bucketed import \
            kernel as bucketed_kernel
        from repro_torch.kernels.psdsf_vds import kernel as vds_kernel
        counters = {"psdsf_fill": fill_kernel.fill_event_levels,
                    "psdsf_fill_bucketed":
                        bucketed_kernel.fill_event_levels_bucketed,
                    "psdsf_vds": vds_kernel.vds_argmin}
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
        for fn in counters.values():
            fn.launches = 0
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
                 "src/repro/kernels/psdsf_vds/kernel.py:55", "float32")):
            main = self.rows[(name, dtype)]
            by_path = {layout: path["launches"][name]
                       for layout, path in self.paths.items()}
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
            f32 = self.rows.get((name, "float32")) if dtype == "float64" \
                else None
            if f32:
                row.update({f"f32_{key}": f32[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "max_abs_err", "shape")})
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
