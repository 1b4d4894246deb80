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
   main path's shapes (one fill event of the 20,000 x 256 datacenter pin in
   float64 and float32, the VDS reduction over that pin's gamma), and times
   both with CUDA events (warm, back to back);
4. drives the main path with every launch count set to 0: the 20,000 x 256
   pin in float64 (``engine.solve``, Jacobi rounds, bisect fill, dense
   layout, 32 rounds at tol=0), its ``min_vds_guarded`` telemetry, the
   20,000 x 1,024 instance in float32 (``psdsf_solve_torch``), and its
   telemetry; then checks the outputs (finite, non-negative, feasible), the
   float64 solve against the same solve with the plain fill to 1e-9, and the
   telemetry against its plain version;
5. profiles two Jacobi rounds for the device-time breakdown;
6. prints the ``kernels`` JSON line, the ``nvidia-smi`` line, and as its
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
        logs = _build.build(["psdsf_fill", "psdsf_vds"])
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
            err, ok = 0.0, True
            for name, a, b in zip(("level", "usage", "local_slope", "slope"),
                                  got, want):
                e = float((a - b).abs().max())
                scale = max(1.0, float(b.abs().max()))
                bound = F64_ATOL * scale if dtype == torch.float64 \
                    else F32_REL * scale
                ok &= e <= bound
                err = max(err, e)
                print(f"  {label} {name}: max|kernel-plain|={e:.3e} "
                      f"(bound {bound:.1e})")
            self.check(ok, f"psdsf_fill {label} disagrees with plain")
            n, k = g.shape
            r = p.num_resources
            b = 8 if dtype == torch.float64 else 4
            nbytes = (2 * n * k + n * r + 2 * k * r + k) * b + k * r \
                + (k + 3 * k * r) * b
            flops = (steps + 3) * n * k * (2 * r + 3)
            bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                           flops / PEAK_FLOPS[label]) * 1e3
            ms = self.time_ms(lambda: kernel.fill_event_levels(
                *args, steps=steps), 10)
            plain_ms = self.time_ms(lambda: ref.fill_event_levels(
                *args, steps=steps), 3)
            print(f"  {label} {n}x{k} R={r} steps={steps}: kernel {ms:.3f} ms,"
                  f" plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                  f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP: "
                  f"bound by "
                  f"{'bytes' if nbytes / PEAK_BYTES_PER_S > flops / PEAK_FLOPS[label] else 'operations'})")
            self.rows[("psdsf_fill", label)] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if nbytes / PEAK_BYTES_PER_S
                > flops / PEAK_FLOPS[label] else "operations",
                max_abs_err=err, shape=f"{n}x{k}x{r}")

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

    def main_path(self):
        import numpy as np
        torch = self.torch
        from repro_torch.core import engine
        from repro_torch.core.dynamic import min_vds_guarded
        from repro_torch.core.psdsf_torch import psdsf_solve_torch
        from repro_torch.kernels.psdsf_fill import kernel as fill_kernel
        from repro_torch.kernels.psdsf_vds import kernel as vds_kernel
        pin, big = self.pin, self.big
        active_pin = np.ones(pin.num_users, dtype=bool)
        active_big = np.ones(big.num_users, dtype=bool)
        big32 = [a.astype(np.float32) for a in (
            big.demands, big.capacities, big.weights, self.big_gamma)]

        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        fill_kernel.fill_event_levels.launches = 0
        vds_kernel.vds_argmin.launches = 0
        self.sync()
        t0 = time.perf_counter()
        alloc, info = engine.solve(pin, "psdsf-rdm", device=self.device,
                                   fill="bisect", round="jacobi",
                                   layout="dense", max_rounds=32, tol=0.0)
        t_f64 = time.perf_counter() - t0
        vds_pin = min_vds_guarded(alloc.x, pin.weights, self.pin_gamma,
                                  active_pin, device=self.device)
        self.sync()
        t0 = time.perf_counter()
        x32, rounds32, resid32 = psdsf_solve_torch(
            *big32, mode="rdm", max_rounds=32, tol=1e-6, fill="bisect",
            round="jacobi", device=self.device)
        self.sync()
        t_f32 = time.perf_counter() - t0
        vds_big = min_vds_guarded(x32, big.weights, self.big_gamma,
                                  active_big, device=self.device)
        self.sync()
        self.launches = {"psdsf_fill": fill_kernel.fill_event_levels.launches,
                         "psdsf_vds": vds_kernel.vds_argmin.launches}

        n, k = pin.num_users, pin.num_servers
        print(f"  f64 {n}x{k}: {t_f64:.3f} s wall, rounds={info.rounds}, "
              f"residual={info.residual:.3e}, stranded="
              f"{info.stranded_frac:.4f}, fill_iters={info.fill_iters}")
        print(f"  f32 {big.num_users}x{big.num_servers}: {t_f32:.3f} s wall, "
              f"rounds={rounds32}, residual={float(resid32):.3e}")
        print(f"  launches on the main path: {self.launches}")
        if self.device.type == "cuda":
            print(f"  peak device memory: "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        self.main = dict(f64_s=t_f64, f64_rounds=info.rounds,
                         f64_resid=info.residual, f32_s=t_f32,
                         f32_rounds=rounds32, f32_resid=float(resid32))
        if not self.rehearse:
            for name, count in self.launches.items():
                self.check(count > 0, f"{name} never launched on the path")

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
        from repro_torch.core.psdsf_torch import _solve_core_torch
        from repro_torch.kernels.psdsf_fill.ref import fill_cluster_plain

        def t(a):
            return torch.as_tensor(a, dtype=torch.float64,
                                   device=self.device).contiguous()
        x_plain, r_plain, _ = _solve_core_torch(
            t(pin.demands), t(pin.capacities), t(pin.weights),
            t(self.pin_gamma), torch.zeros((n, k), dtype=torch.float64,
                                           device=self.device),
            "rdm", 32, 0.0, fill="bisect", round_mode="jacobi",
            cluster_fill=fill_cluster_plain)
        diff = float(np.abs(x_plain.cpu().numpy() - alloc.x).max())
        print(f"  f64 kernel-driven vs plain-driven solve: max|dx|="
              f"{diff:.3e} over {r_plain} rounds")
        self.check(r_plain == info.rounds and diff <= F64_ATOL,
                   "kernel-driven and plain-driven solves disagree")

        from repro_torch.kernels.psdsf_vds.ref import vds_argmin
        for what, got, x, p, g in (
                ("f64 pin", vds_pin, t(alloc.x), pin, self.pin_gamma),
                ("f32 1024", vds_big, x32, big, self.big_gamma)):
            xo = (x.sum(dim=1) / t(p.weights)).float()
            self.compare_vds(got, vds_argmin(xo, torch.as_tensor(
                g, dtype=torch.float32, device=self.device)), what)

    def profile(self):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.core import engine
        pin = self.pin
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)

        def run(rounds):
            engine.solve(pin, "psdsf-rdm", device=self.device, fill="bisect",
                         round="jacobi", layout="dense", max_rounds=rounds,
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
            print("  profiler saw no device time: not measured")
            return
        fill_ms = sum(r[0] for r in rows if "fill_event_kernel" in r[1]) / 1e3
        print(f"  engine.solve f64 {pin.num_users}x{pin.num_servers}, 32 "
              f"Jacobi rounds, profiled: wall {wall_ms:.1f} ms, device busy "
              f"{busy_ms:.1f} ms (psdsf_fill {fill_ms:.1f} ms, other kernels "
              f"and copies {busy_ms - fill_ms:.1f} ms), idle share "
              f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
        for us, key, count in rows[:8]:
            print(f"    {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
        host = sorted(((float(e.self_cpu_time_total), e.key, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU), reverse=True)
        print("  host self time, top 5:")
        for us, key, count in host[:5]:
            print(f"    {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")

    def report(self):
        kernels = []
        for name, source, replaces in (
                ("psdsf_fill", "src/repro_torch/kernels/csrc/psdsf_fill.cu",
                 "src/repro/kernels/psdsf_fill/kernel.py:124"),
                ("psdsf_vds", "src/repro_torch/kernels/csrc/psdsf_vds.cu",
                 "src/repro/kernels/psdsf_vds/kernel.py:55")):
            main = self.rows[(name, "float64" if name == "psdsf_fill"
                              else "float32")]
            row = {"name": name, "route": "cuda", "source": source,
                   "replaces": replaces,
                   "launches": self.launches[name],
                   "max_abs_err": main["max_abs_err"], "ms": main["ms"],
                   "plain_ms": main["plain_ms"],
                   "bound_ms": main["bound_ms"],
                   "bound_by": main["bound_by"],
                   "library_ms": main.get("library_ms"),
                   "shape": main["shape"],
                   "dtype": "float64" if name == "psdsf_fill" else "float32"}
            if name == "psdsf_fill":
                f32 = self.rows[(name, "float32")]
                row.update({f"f32_{key}": f32[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "max_abs_err", "shape")})
            kernels.append(row)
        print(json.dumps({"kernels": kernels, "main_path": self.main}))


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
        smoke.phase("psdsf_vds vs plain", smoke.vds_vs_plain)
        smoke.phase("main path", smoke.main_path)
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
