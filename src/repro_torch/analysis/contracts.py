"""The port's contracts, which its lint checks the port against — the
port's counterpart of ``repro/analysis/contracts.py``.

The single place where a new engine axis, entry point, kernel package or
observability field of the port must be registered. The passes
cross-check these tables against the port's AST, so forgetting to update
a table is itself a finding (``AX106``): declaring an axis without giving
every entry point a spec (or an explicit ``n/a`` waiver) fails
``--check``.

The axis-spec schema is the reference's (one row per entry point, one cell
per axis):

* ``dict(param=..., forward=..., via=..., sinks=..., require_direct=...)``
  -- the entry accepts the axis. ``param`` (default: the axis name) is the
  parameter that carries it (``backend`` travels as ``engine=`` on the
  tick layer, ``mechanism`` as ``mode=`` on the PS-DSF solves).
  ``via="kwargs"`` means the axis rides the entry's ``**kwargs``.
  ``forward=True`` requires the value to reach a callee. ``sinks`` lists
  functions that must each validate the axis themselves (the multi-layer
  guarantee); ``require_direct=True`` additionally demands validation in
  the entry itself.
* a string -- an explicit waiver: the axis does not apply to this entry,
  and the string is the one-line justification.

Every function a table names is the port's (``src/repro_torch``): the
port's lint parses none of the reference.
"""
from __future__ import annotations

#: the eight engine axes, the reference's
AXES = ("mechanism", "backend", "placement", "fill", "round", "layout",
        "precision", "accel")

#: ``engine.solve`` dispatches by mechanism to these, each of which must
#: validate the axes it receives (the reference's registry allocators'
#: role)
_SOLVE_SINKS = ("psdsf_solve_torch", "solve_baseline_torch", "_drf_torch",
                "_uniform_torch")

_F64 = ("n/a — the problem's float64 arrays solve in float64; precision "
        "is a DistributedPSDSF tick knob")
_IS_TORCH = ("n/a — this IS the port's device backend; backend dispatch is "
             "engine.solve")
_DTYPE = "n/a — dtype follows the input arrays (_solve_dtype)"

ENTRY_POINTS = {
    ("src/repro_torch/core/engine.py", "solve"): {
        "mechanism": dict(forward=True),
        "backend": dict(forward=False),
        "placement": dict(forward=True),
        "fill": dict(forward=True, sinks=_SOLVE_SINKS),
        "round": dict(forward=True, sinks=_SOLVE_SINKS),
        "layout": dict(forward=True, sinks=_SOLVE_SINKS),
        "precision": _F64,
        "accel": dict(forward=True, sinks=_SOLVE_SINKS),
    },
    ("src/repro_torch/core/psdsf_torch.py", "psdsf_solve_torch"): {
        "mechanism": dict(param="mode", forward=True),
        "backend": _IS_TORCH,
        "placement": dict(forward=True),
        "fill": dict(forward=True),
        "round": dict(forward=True),
        "layout": dict(forward=True),
        "precision": _DTYPE,
        "accel": dict(forward=True),
    },
    ("src/repro_torch/core/batched.py", "psdsf_solve_batched"): {
        "mechanism": dict(param="mode", forward=True),
        "backend": _IS_TORCH,
        "placement": dict(forward=True),
        "fill": dict(forward=True),
        "round": dict(forward=True),
        "layout": dict(forward=True),
        "precision": _DTYPE,
        "accel": dict(forward=True),
    },
    ("src/repro_torch/core/batched.py", "psdsf_resolve_batched"): {
        "mechanism": dict(param="mode", forward=True),
        "backend": _IS_TORCH,
        "placement": dict(forward=True),
        "fill": dict(forward=True),
        "round": dict(forward=True),
        "layout": dict(forward=True),
        "precision": _DTYPE,
        "accel": dict(forward=True),
    },
    ("src/repro_torch/core/baselines_torch.py", "baseline_solve_torch"): {
        "mechanism": "n/a — takes the prebuilt level-rate matrix; build it "
                     "with level_rate_matrix_np/_torch, which validate",
        "backend": _IS_TORCH,
        "placement": dict(forward=True),
        "fill": dict(forward=True),
        "round": dict(forward=True),
        "layout": dict(forward=True),
        "precision": _DTYPE,
        "accel": dict(forward=True),
    },
    ("src/repro_torch/core/baselines_torch.py",
     "baseline_solve_batched_torch"): {
        "mechanism": "n/a — takes the prebuilt level-rate matrix; build it "
                     "with level_rate_matrix_np/_torch, which validate",
        "backend": _IS_TORCH,
        "placement": dict(forward=True),
        "fill": dict(forward=True),
        "round": dict(forward=True),
        "layout": dict(forward=True),
        "precision": _DTYPE,
        "accel": dict(forward=True),
    },
    ("src/repro_torch/core/baselines_torch.py", "solve_baseline_torch"): {
        "mechanism": dict(forward=True),
        "backend": _IS_TORCH,
        "placement": dict(forward=True),
        "fill": dict(forward=True),
        "round": dict(forward=True),
        "layout": dict(forward=True),
        "precision": "n/a — the problem's float64 arrays solve in float64",
        "accel": dict(forward=True),
    },
    ("src/repro_torch/core/dynamic.py", "DistributedPSDSF.__init__"): {
        "mechanism": dict(param="mode", forward=False),
        "backend": dict(param="engine", forward=False),
        "placement": dict(forward=True),
        "fill": dict(forward=False),
        "round": "n/a — a tick is a single asynchronous sweep visit; there "
                 "is no outer iteration to choose",
        "layout": dict(forward=True),
        "precision": dict(forward=False),
        "accel": dict(forward=False),
    },
    ("src/repro_torch/sched/serving.py", "DynamicDispatcher.__init__"): {
        "mechanism": dict(param="mode", forward=True),
        "backend": dict(param="engine", forward=True),
        "placement": dict(forward=True),
        "fill": dict(forward=True),
        "round": "n/a — delegates to DistributedPSDSF, whose tick has no "
                 "outer iteration",
        "layout": dict(forward=True),
        "precision": dict(forward=True),
        "accel": dict(forward=True),
    },
    ("src/repro_torch/sched/churn.py", "ChurnSimulator.__init__"): {
        "mechanism": dict(forward=False),
        "backend": "n/a — the churn tick always runs the port's device "
                   "engine",
        "placement": dict(forward=False),
        "fill": dict(forward=False),
        "round": dict(forward=False),
        "layout": dict(forward=True),
        "precision": "n/a — the tick engine runs float32 buffers by design "
                     "(10^3-user churn scale), as the reference's",
        "accel": dict(forward=False),
    },
    ("src/repro_torch/sched/cluster.py", "schedule"): {
        "mechanism": dict(forward=True),
        "backend": "n/a — the schedulers call engine.solve on the port's "
                   "device backend",
        "placement": dict(forward=True),
        "fill": dict(via="kwargs", forward=True),
        "round": dict(via="kwargs", forward=True),
        "layout": dict(via="kwargs", forward=True),
        "precision": _F64,
        "accel": dict(via="kwargs", forward=True),
    },
    ("src/repro_torch/sched/cluster.py", "schedule_detail"): {
        "mechanism": dict(forward=True),
        "backend": "n/a — the schedulers call engine.solve on the port's "
                   "device backend",
        "placement": dict(forward=True),
        "fill": dict(via="kwargs", forward=True),
        "round": dict(via="kwargs", forward=True),
        "layout": dict(via="kwargs", forward=True),
        "precision": _F64,
        "accel": dict(via="kwargs", forward=True),
    },
    ("src/repro_torch/sched/serving.py", "admitted_rates"): {
        "mechanism": dict(forward=True),
        "backend": "n/a — the schedulers call engine.solve on the port's "
                   "device backend",
        "placement": dict(forward=True),
        "fill": dict(via="kwargs", forward=True),
        "round": dict(via="kwargs", forward=True),
        "layout": dict(via="kwargs", forward=True),
        "precision": _F64,
        "accel": dict(via="kwargs", forward=True),
    },
}

#: modules whose decorators' ``static_argnames`` are swept for axis names
#: nobody declared (AX108): the port jits nothing, so none
STATIC_ARGNAME_MODULES = ()

#: static argnames that are not engine axes (the reference's set)
STATIC_NON_AXES = frozenset({"mode", "engine", "round_mode", "max_rounds",
                             "mechanism"}) | frozenset(AXES)


# ---------------------------------------------------------------------------
# host syncs (the port's counterpart of the reference's jit purity)

HOST_SYNC = dict(
    #: directories scanned for the sweep and tick loops and their callees
    scan_dirs=("src/repro_torch/core", "src/repro_torch/sched"),
    #: the loops the device should run without waiting on the host: the
    #: reference's traced roots under the port's names, and the tick
    #: bodies of core/dynamic.py
    root_patterns=(r"^_solve_core.*_torch$", r"^_fill_one_server",
                   r"^_repack_core_torch$", r"^_repack_refill_core_torch$",
                   r"^_routed_fill_core_torch$",
                   r"^stranded_fraction_torch$", r"^_tick_torch"),
    #: host-side validation helpers on plain arguments, excluded from the
    #: closure (the reference's trace-time gates)
    host_gates=frozenset({
        "check_placement", "check_axes", "_check_core_axes",
        "_check_buckets", "_reject_lexmm_torch", "_reject_routed_bucketed",
        "resolve_device"}),
)


# ---------------------------------------------------------------------------
# kernel triples

KERNELS = dict(
    dir="src/repro_torch/kernels",
    triple=("kernel.py", "ops.py", "ref.py"),
    #: each package's CPU test file, which must import it; the card's
    #: gpu-marked file, which must too; the CUDA sources' directory
    default_test="tests/test_torch_attention.py",
    tests={
        "psdsf_fill": "tests/test_torch_fill.py",
        "psdsf_fill_bucketed": "tests/test_torch_bucketed.py",
        "psdsf_vds": "tests/test_torch_vds.py",
        "flash_attention": "tests/test_torch_attention.py",
        "decode_attention": "tests/test_torch_attention.py",
        "ssd_scan": "tests/test_torch_ssd.py",
    },
    csrc="src/repro_torch/kernels/csrc",
    gpu_test="tests/test_torch_cuda.py",
)


# ---------------------------------------------------------------------------
# observability coverage

OBSERVABILITY = {
    "SolveInfo": dict(
        module="src/repro_torch/core/solveinfo.py",
        writer_groups={
            "torch": ("src/repro_torch/core/engine.py",
                      "src/repro_torch/core/baselines_torch.py"),
        },
        waivers={},
    ),
    "ChurnRecord": dict(
        module="src/repro_torch/sched/churn.py",
        writer_groups={
            "tick": ("src/repro_torch/sched/churn.py",),
        },
        waivers={},
    ),
}


# ---------------------------------------------------------------------------
# docstring coverage

DOCSTRINGS = dict(
    packages=("src/repro_torch/core", "src/repro_torch/sched"),
    min_percent=95.0,
)

#: the port's committed baseline
BASELINE_PATH = "src/repro_torch/analysis/baseline.json"
