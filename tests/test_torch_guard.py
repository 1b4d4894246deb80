"""Boundary guards of the port: it imports neither ``jax`` nor anything of
``repro``; its entry points run on the card unless asked for the CPU; its
CUDA wrappers import on any machine and reach ``nvcc``/``ctypes`` only for
CUDA tensors; and it defines nothing under a name the reference's contract
lint declares as a sink (the lint grounds sinks by base name across the
whole of ``src/``)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import kernel as decode_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.psdsf_fill import kernel as fill_kernel
from repro_torch.kernels.psdsf_fill_bucketed import kernel as bucketed_kernel
from repro_torch.kernels.psdsf_vds import kernel as vds_kernel

ROOT = Path(__file__).resolve().parents[1]
PORT_MODULES = sorted(
    "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                              .with_suffix("").parts)
    for p in (ROOT / "src" / "repro_torch").rglob("*.py")
    if p.name != "__init__.py")


def test_port_modules_listed():
    assert "repro_torch.core.psdsf_torch" in PORT_MODULES
    assert "repro_torch.kernels.psdsf_vds.kernel" in PORT_MODULES
    for name in ("configs.qwen3_1_7b", "models.config", "models.common",
                 "models.mlp", "models.attention", "models.blocks",
                 "models.model", "models.convert", "serve.engine",
                 "launch.serve", "kernels.flash_attention.kernel",
                 "kernels.flash_attention.ops", "kernels.flash_attention.ref",
                 "kernels.decode_attention.kernel",
                 "kernels.decode_attention.ops",
                 "kernels.decode_attention.ref", "configs.mamba2_1_3b",
                 "models.ssm", "kernels.ssd_scan.kernel",
                 "kernels.ssd_scan.ops", "kernels.ssd_scan.ref",
                 "sched.churn", "core.dynamic", "core.batched",
                 "core.placement_torch", "core.baselines_torch",
                 "core.trace", "core.flowrouter", "sched.cluster",
                 "sched.serving", "models.moe", "configs.granite_moe_3b_a800m",
                 "configs.jamba_v0_1_52b", "configs.grok_1_314b",
                 "train.optimizer", "train.step", "data.pipeline",
                 "ckpt.manager", "ft.failures", "train.compression",
                 "train.trainer", "launch.train", "launch.mesh",
                 "launch.sharding", "launch.specs", "launch.collectives",
                 "launch.dryrun", "launch.roofline", "analysis.__main__",
                 "analysis.findings", "analysis.model", "analysis.contracts",
                 "analysis.axis_threading", "analysis.host_sync",
                 "analysis.kernel_triples", "analysis.observability",
                 "analysis.docstrings", "analysis.runner"):
        assert f"repro_torch.{name}" in PORT_MODULES, name


def test_port_imports_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        "import repro_torch\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "from repro_torch.core.instances import fig1_instance\n"
        "from repro_torch.core import engine\n"
        "a, _ = engine.solve(fig1_instance(), device='cpu', fill='bisect',\n"
        "                    round='jacobi', tol=1e-10, max_rounds=512)\n"
        "assert abs(a.tasks_per_user - [3, 3, 6]).max() < 1e-6\n"
        "import contextlib, io\n"
        "from repro_torch.launch import serve\n"
        "for arch in ('qwen3_1_7b', 'mamba2_1_3b',\n"
        "             'granite-moe-3b-a800m'):\n"
        "    with contextlib.redirect_stdout(io.StringIO()):\n"
        "        done = serve.main(['--arch', arch, '--smoke', '--device',\n"
        "                           'cpu', '--requests', '3', '--max-new',\n"
        "                           '2'])\n"
        "    assert len(done) == 3\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.models.model import init_params\n"
        "from repro_torch.train import (OptimizerConfig,\n"
        "                               build_train_step_torch,\n"
        "                               make_train_state_torch)\n"
        "cfg = get_smoke_config('jamba_v0_1_52b')\n"
        "state = make_train_state_torch(cfg, init_params(cfg, device='cpu'),\n"
        "                               OptimizerConfig(), device='cpu')\n"
        "tok = [[1, 2, 3, 4] * 4] * 2\n"
        "_, met = build_train_step_torch(cfg, OptimizerConfig(), 2,\n"
        "                                device='cpu')(\n"
        "    state, {'tokens': tok, 'labels': tok})\n"
        "assert float(met['grad_norm']) > 0\n"
        "import tempfile\n"
        "from repro_torch.launch import train\n"
        "with tempfile.TemporaryDirectory() as d, \\\n"
        "        contextlib.redirect_stdout(io.StringIO()):\n"
        "    out = train.main(['--smoke', '--steps', '2', '--seq-len', '8',\n"
        "                      '--global-batch', '2', '--device', 'cpu',\n"
        "                      '--ckpt-dir', d])\n"
        "assert len(out['losses']) == 2\n"
        "from repro_torch.ft import ElasticController\n"
        "from repro_torch.sched import Cluster, TenantJob, TPUPod, schedule\n"
        "ctl = ElasticController(\n"
        "    Cluster([TPUPod('a', 'v5e', 64, 16, 128, 400, 25)]),\n"
        "    [TenantJob('j', 1.0, 8, 100, 16, 50, 0)],\n"
        "    lambda c, j: schedule(c, j, device='cpu'))\n"
        "assert ctl.allocation['j'] > 0\n"
        "from repro_torch.configs import ShapeSpec\n"
        "from repro_torch.launch.dryrun import lower_cell_torch\n"
        "from repro_torch.launch.roofline import analyze_artifact_np\n"
        "res = lower_cell_torch('qwen3_1_7b', 'd', mesh_shape=(1, 1),\n"
        "                       shape=ShapeSpec('d', 'decode', 16, 2),\n"
        "                       smoke=True)\n"
        "assert res['ok'] and analyze_artifact_np(res)['bound_s'] > 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'jaxlib')) or m == 'repro'\n"
        "             or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_cuda):
    from repro_torch import resolve_device
    from repro_torch.core import engine
    from repro_torch.core.dynamic import min_vds_guarded
    from repro_torch.core.gamma import gamma_matrix
    from repro_torch.core.instances import fig1_instance
    from repro_torch.core.psdsf_torch import (psdsf_solve_torch,
                                              solve_psdsf_rdm_torch)
    from repro_torch.core.dynamic import DistributedPSDSF
    from repro_torch.core.batched import (batch_problems,
                                          psdsf_resolve_batched,
                                          psdsf_solve_batched)
    from repro_torch.sched import ChurnSimulator
    from repro_torch.core.baselines_torch import (
        baseline_solve_batched_torch, baseline_solve_torch,
        batch_level_rates_torch, level_rate_matrix_np, solve_baseline_torch)
    from repro_torch.core.engine import _drf_torch, _uniform_torch
    from repro_torch.sched import (Cluster, DynamicDispatcher, ReplicaGroup,
                                   Tenant, TenantJob, TPUPod,
                                   admitted_rates, schedule, schedule_detail)
    fleet = Cluster([TPUPod("a", "v5e", 64, 16, 128, 400, 25)])
    jobs = [TenantJob("j", 1.0, 8, 100, 16, 50, 0)]
    groups = [ReplicaGroup("g", 64, 256, 50_000, max_context=32768)]
    tenants = [Tenant("t", 1.0, 4096, 0.5, 2048)]
    prob = fig1_instance()
    g = gamma_matrix(prob)
    lg = level_rate_matrix_np(prob, "tsf")
    stacked = [a[None] for a in (prob.demands, prob.capacities,
                                 prob.weights, g)]
    calls = [
        lambda: engine.solve(prob, placement="headroom"),
        lambda: engine.solve(prob, "tsf"),
        lambda: engine.solve(prob, "cdrfh", placement="headroom"),
        lambda: engine.solve(prob, "drf"),
        lambda: engine.solve(prob, "uniform"),
        lambda: _drf_torch(prob),
        lambda: _uniform_torch(prob),
        lambda: solve_baseline_torch(prob, "cdrf"),
        lambda: baseline_solve_torch(prob.demands, prob.capacities,
                                     prob.weights, lg),
        lambda: baseline_solve_batched_torch(*stacked[:3], lg[None]),
        lambda: batch_level_rates_torch([prob], "tsf"),
        lambda: ChurnSimulator(prob, mechanism="tsf"),
        lambda: engine.solve(prob, "tsf", placement="lexmm"),
        lambda: engine.solve(prob, "cdrf", placement="lexmm"),
        lambda: solve_baseline_torch(prob, "cdrfh", placement="lexmm"),
        lambda: ChurnSimulator(prob, mechanism="tsf", placement="lexmm"),
        lambda: schedule(fleet, jobs),
        lambda: schedule(fleet, jobs, "tsf", placement="lexmm"),
        lambda: schedule_detail(fleet, jobs),
        lambda: admitted_rates(groups, tenants),
        lambda: admitted_rates(groups, tenants, "cdrf", placement="lexmm"),
        lambda: DynamicDispatcher(groups, tenants),
        lambda: DynamicDispatcher(groups, tenants, precision="fast"),
        lambda: ChurnSimulator(prob, placement="headroom"),
        lambda: DistributedPSDSF(prob, placement="headroom"),
        lambda: resolve_device(),
        lambda: engine.solve(prob),
        lambda: psdsf_solve_torch(prob.demands, prob.capacities,
                                  prob.weights, g),
        lambda: solve_psdsf_rdm_torch(prob),
        lambda: min_vds_guarded(np.ones((3, 2)), prob.weights, g,
                                np.ones(3, bool)),
        lambda: ChurnSimulator(prob),
        lambda: DistributedPSDSF(prob),
        lambda: psdsf_solve_batched(*stacked),
        lambda: psdsf_resolve_batched(*stacked, np.zeros((1, 3, 2)),
                                      np.zeros((1, 1), np.int32)),
        lambda: batch_problems([prob]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.fixture()
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel build")
    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)


def test_wrappers_take_plain_version_for_cpu_tensors(no_build):
    n, k, r = 5, 3, 2
    g = torch.Generator().manual_seed(0)
    floors = torch.rand(n, k, generator=g, dtype=torch.float64)
    rate = torch.rand(n, k, generator=g, dtype=torch.float64)
    dem = torch.rand(n, r, generator=g, dtype=torch.float64)
    caps = 5 + torch.rand(k, r, generator=g, dtype=torch.float64)
    before = (fill_kernel.fill_event_levels.launches,
              vds_kernel.vds_argmin.launches)
    lvl, u, lsl, slope = fill_kernel.fill_event_levels(
        floors, rate, dem, caps, torch.zeros_like(caps),
        torch.zeros(k, r, dtype=torch.bool), torch.zeros(k,
                                                         dtype=torch.float64),
        steps=48)
    assert lvl.shape == (k,) and u.shape == lsl.shape == slope.shape == (k, r)
    mn, arg = vds_kernel.vds_argmin(rate[:, 0].float(), floors.float())
    assert mn.shape == arg.shape == (k,)
    assert (fill_kernel.fill_event_levels.launches,
            vds_kernel.vds_argmin.launches) == before


def test_wrappers_refuse_other_devices(no_build):
    meta = torch.empty((4, 2), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        vds_kernel.vds_argmin(meta[:, 0], meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fill_kernel.fill_event_levels(meta, meta, meta, meta, meta, meta,
                                      meta[:, 0], steps=1)


def test_library_name_follows_source(tmp_path, monkeypatch):
    for name in ("psdsf_fill", "psdsf_fill_bucketed", "psdsf_vds",
                 "flash_attention", "decode_attention", "ssd_scan"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "extern \"C\"" in src and "Replaces the TPU kernel" in src
        (tmp_path / f"{name}.cu").write_text(src)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("psdsf_fill")
    assert before.parent.name == "kernels" and before.parent.parent.name \
        == "build"
    (tmp_path / "psdsf_fill.cu").write_text(src + "\n// edited\n")
    assert _build.library_path("psdsf_fill") != before


def test_bucketed_wrapper_takes_plain_version_for_cpu_tensors(no_build):
    k, b, r = 3, 4, 2
    g = torch.Generator().manual_seed(1)
    floors = torch.rand(k, b, generator=g, dtype=torch.float64)
    rate = torch.rand(k, b, generator=g, dtype=torch.float64)
    dem = torch.rand(k, b, r, generator=g, dtype=torch.float64)
    caps = 5 + torch.rand(k, r, generator=g, dtype=torch.float64)
    before = bucketed_kernel.fill_event_levels_bucketed.launches
    lvl, u, lsl, slope = bucketed_kernel.fill_event_levels_bucketed(
        floors, rate, dem, caps, torch.zeros_like(caps),
        torch.zeros(k, r, dtype=torch.bool),
        torch.zeros(k, dtype=torch.float64), steps=48)
    assert lvl.shape == (k,) and u.shape == lsl.shape == slope.shape == (k, r)
    assert bucketed_kernel.fill_event_levels_bucketed.launches == before
    meta = torch.empty((4, 2), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bucketed_kernel.fill_event_levels_bucketed(
            meta, meta, meta[..., None], meta, meta, meta, meta[:, 0],
            steps=1)


def test_sparse_entry_points_default_to_cuda(no_cuda):
    # the bucketed path resolves the device before building its layout
    from repro_torch.core import engine
    from repro_torch.core.gamma import gamma_matrix
    from repro_torch.core.instances import sparse_cell_instance
    from repro_torch.core.layout import BucketedLayout
    from repro_torch.core.psdsf_torch import psdsf_solve_torch
    prob, _ = sparse_cell_instance(num_users=160, num_servers=16, cells=4)
    g = gamma_matrix(prob)
    lay = BucketedLayout.from_support(g > 0)
    for call in (lambda: engine.solve(prob),
                 lambda: engine.solve(prob, layout="bucketed",
                                      accel="anderson"),
                 lambda: psdsf_solve_torch(
                     prob.demands, prob.capacities, prob.weights, g,
                     layout="bucketed", buckets=(lay.indices, lay.mask))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_convenience_wrappers_take_anderson():
    # accel="anderson" extends psdsf_solve_torch's return tuple; the
    # Allocation wrappers keep returning the allocation alone
    from repro_torch.core.instances import fig1_instance
    from repro_torch.core.psdsf_torch import (solve_psdsf_rdm_torch,
                                              solve_psdsf_tdm_torch)
    for fn in (solve_psdsf_rdm_torch, solve_psdsf_tdm_torch):
        alloc = fn(fig1_instance(), max_rounds=128, accel="anderson",
                   device="cpu")
        np.testing.assert_allclose(alloc.tasks_per_user, [3.0, 3.0, 6.0],
                                   atol=1e-6)


def test_serving_entry_points_default_to_cuda(no_cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.model import (forward_decode, forward_prefill,
                                          init_caches, init_params)
    from repro_torch.serve import ServingEngine
    for arch in ("qwen3_1_7b", "mamba2_1_3b", "granite_moe_3b_a800m",
                 "jamba_v0_1_52b", "grok_1_314b"):
        cfg = get_smoke_config(arch)
        params = init_params(cfg, device="cpu")
        caches = init_caches(cfg, 1, 8, device="cpu")
        calls = [
            lambda: ServingEngine(cfg),
            lambda: ServingEngine(cfg, params=params),
            lambda: init_params(cfg),
            lambda: init_caches(cfg, 1, 8),
            lambda: forward_prefill(cfg, params, [[1, 2, 3]]),
            lambda: forward_decode(cfg, params, caches, [1], 0),
            lambda: serve.main(["--arch", arch, "--smoke"]),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        logits, _ = forward_prefill(cfg, params, [[1, 2, 3]], device="cpu")
        assert logits.shape == (1, cfg.vocab_padded)
        eng = ServingEngine(cfg, params=params, max_slots=2, max_len=8,
                            device="cpu")
        assert eng.device == torch.device("cpu")


def test_attention_wrappers_take_plain_version_for_cpu_tensors(no_build):
    g = torch.Generator().manual_seed(2)
    q = torch.randn(1, 5, 4, 16, generator=g)
    k = torch.randn(1, 5, 2, 16, generator=g)
    before = (flash_kernel.flash_attention.launches,
              decode_kernel.decode_attention.launches)
    out = flash_kernel.flash_attention(q, k, k)
    assert out.shape == q.shape
    out = decode_kernel.decode_attention(q[:, 0], k, k,
                                         torch.tensor([3], dtype=torch.int32))
    assert out.shape == (1, 4, 16)
    assert (flash_kernel.flash_attention.launches,
            decode_kernel.decode_attention.launches) == before
    meta = torch.empty((1, 5, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_kernel.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        decode_kernel.decode_attention(meta[:, 0], meta, meta,
                                       torch.empty((1,), device="meta"))


def test_unported_configs_name_their_roadmap_item():
    # every arch is ported: each resolves, to the reference's config, and
    # nothing waits for a ROADMAP item
    import dataclasses

    from repro.configs import ARCH_IDS as REF_ARCH_IDS
    from repro.configs import get_config as ref_get_config
    from repro_torch.configs import ARCH_IDS, PORTED, WAITS_FOR, get_config
    from repro_torch.models.config import ModelConfig
    assert ARCH_IDS == REF_ARCH_IDS
    assert set(PORTED) == set(ARCH_IDS) and not WAITS_FOR
    for arch in ARCH_IDS:
        assert get_config(arch).name == arch
        assert get_config(arch) == ModelConfig(
            **dataclasses.asdict(ref_get_config(arch)))


def _sink_names():
    """The base names the reference's lint resolves as sinks: the
    registry's allocators and every ``sinks`` entry of an entry point's
    axis specs."""
    from repro.analysis import contracts
    names = set(contracts._ALLOCATOR_SINKS)
    for specs in contracts.ENTRY_POINTS.values():
        for spec in specs.values():
            if isinstance(spec, dict):
                names.update(spec.get("sinks", ()))
    return names


def test_no_definition_takes_a_lint_sink_name():
    sinks = _sink_names()
    assert {"_drf", "_uniform", "solve_tsf", "solve_baseline_jax",
            "_solve_psdsf_via_jax"} <= sinks
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += sorted((ROOT / "tests").glob("test_torch_*.py"))
    assert len(files) > 40
    found = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)) and node.name in sinks:
                found.append(f"{path.relative_to(ROOT)}:{node.lineno} "
                             f"{node.name}")
    assert not found, "lint sink names defined: " + ", ".join(found)


#: the scheduler layers' public names, which mirror the reference's on
#: purpose (a user of either package calls the same names); the other
#: module-level functions of the router and scheduler modules take names
#: of their own
MIRRORED_NAMES = {"schedule", "schedule_detail", "admitted_rates",
                  "dispatch_problem", "job_from_artifact", "ensure_converged"}
#: the modules the host router and the scheduler layers added to the port
ROUTER_AND_SCHEDULER_MODULES = ("core/trace.py", "core/flowrouter.py",
                                "sched/cluster.py", "sched/serving.py")


def _module_functions(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    return {node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))}


def test_new_module_functions_take_names_of_their_own():
    reference = set()
    for path in (ROOT / "src" / "repro").rglob("*.py"):
        tree = ast.parse(path.read_text(), filename=str(path))
        reference.update(node.name for node in ast.walk(tree)
                         if isinstance(node, (ast.FunctionDef,
                                              ast.AsyncFunctionDef)))
    assert {"lexmm_route", "_level_rates", "schedule"} <= reference
    port = ROOT / "src" / "repro_torch"
    added = set()
    for rel in ROUTER_AND_SCHEDULER_MODULES:
        added |= _module_functions(port / rel)
    # ensure_converged joined core/engine.py with this slice
    assert {"ensure_converged", "solve"} <= _module_functions(
        port / "core" / "engine.py")
    added.add("ensure_converged")
    assert {"lexmm_route_np", "lexmm_route_cold_np", "_level_rates_np",
            "_solve_lp_np", "_highs_np", "_generation_allowed_np",
            "_solve_placed_torch"} <= added
    shared = sorted((added & reference) - MIRRORED_NAMES)
    assert not shared, f"port functions named like the reference's: {shared}"
    assert MIRRORED_NAMES <= added


def test_moe_functions_take_names_of_their_own():
    # models/moe.py mirrors the reference's moe.py function for function;
    # each module-level function takes a name of its own (P2)
    reference = _module_functions(ROOT / "src" / "repro" / "models" /
                                  "moe.py")
    assert {"_route", "_expert_ffn", "moe_apply", "moe_apply_gather"} <= \
        reference
    port = _module_functions(ROOT / "src" / "repro_torch" / "models" /
                             "moe.py")
    assert {"_route_torch", "_expert_ffn_torch", "moe_apply_torch",
            "moe_apply_gather_torch", "moe_apply_dense_torch",
            "moe_group_plan_torch"} <= port
    assert not port & reference


#: the reference's training functions the port's training slice mirrors;
#: each port counterpart takes a name of its own (``_torch``)
TRAIN_REFERENCE = {
    "train/optimizer.py": {"schedule", "init_opt_state", "global_norm",
                           "adamw_update"},
    "train/step.py": {"make_train_state", "build_train_step"},
    "models/model.py": {"forward_train", "softmax_xent"},
    "models/attention.py": {"attention_train", "_attend_any",
                            "_make_flash_train"},
    "models/blocks.py": {"_group_train", "stack_train"},
    "data/pipeline.py": {"global_batch_at"},
    "train/compression.py": {"_blocked", "quantize_int8", "dequantize_int8",
                             "ef_compress_decompress",
                             "compressed_cross_pod_mean", "init_residuals",
                             "wire_bytes_ratio"},
    "ckpt/manager.py": {"_flatten"},
}


def _all_definitions(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    return {node.name for node in ast.walk(tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef))}


def test_train_functions_take_names_of_their_own():
    ref_root = ROOT / "src" / "repro"
    port_root = ROOT / "src" / "repro_torch"
    for rel, names in TRAIN_REFERENCE.items():
        assert names <= _module_functions(ref_root / rel), rel
        assert not _all_definitions(port_root / rel) & names, rel
    assert {"lr_schedule_torch", "init_opt_state_torch", "global_norm_torch",
            "adamw_update_torch"} <= _module_functions(
        port_root / "train" / "optimizer.py")
    assert {"make_train_state_torch", "build_train_step_torch"} <= \
        _module_functions(port_root / "train" / "step.py")
    assert "global_batch_at_torch" in _module_functions(
        port_root / "data" / "pipeline.py")
    assert {"quantize_int8_torch", "dequantize_int8_torch",
            "ef_compress_decompress_torch", "init_residuals_torch",
            "wire_bytes_ratio_np"} <= _module_functions(
        port_root / "train" / "compression.py")
    assert "_flatten_state_torch" in _module_functions(
        port_root / "ckpt" / "manager.py")
    # no port definition is named ``schedule`` but the scheduler layer's,
    # which mirrors the reference's ``repro.sched.schedule`` on purpose
    named = sorted(str(p.relative_to(port_root))
                   for p in port_root.rglob("*.py")
                   if "schedule" in _all_definitions(p))
    assert named == ["sched/cluster.py"], named


#: the launch tooling's modules and the functions they added
#: to modules the port had
LAUNCH_MODULES = ("launch/mesh.py", "launch/sharding.py", "launch/specs.py",
                  "launch/collectives.py", "launch/dryrun.py",
                  "launch/roofline.py")
LAUNCH_ADDED = {
    "models/common.py": {"constrain_torch", "shard_axes_torch",
                         "placements_of_torch", "unshard_dp_torch",
                         "layout_of_torch", "local_region_torch"},
    "models/model.py": {"abstract_params_torch", "abstract_caches_torch"},
    "train/step.py": {"abstract_train_state_torch"},
    "train/compression.py": {"compressed_cross_pod_mean_torch"},
    "configs/__init__.py": {"shape_applicable_np", "all_cells_np"},
}


def test_launch_functions_take_names_of_their_own():
    reference = set()
    for path in (ROOT / "src" / "repro").rglob("*.py"):
        reference |= _all_definitions(path)
    assert {"param_specs", "lower_cell", "analyze_artifact", "constrain",
            "make_production_mesh", "compressed_cross_pod_mean",
            "shape_applicable", "input_specs"} <= reference
    port = ROOT / "src" / "repro_torch"
    added = set()
    for rel in LAUNCH_MODULES:
        added |= _module_functions(port / rel)
    assert {"make_production_mesh_torch", "make_debug_mesh_torch",
            "dp_axes_torch", "param_specs_np", "sanitize_specs_np",
            "placements_torch", "distribute_state_torch",
            "input_specs_torch", "op_histogram_torch", "wire_bytes_np",
            "lower_cell_torch", "analyze_artifact_np", "suggestion_np",
            "format_table_np", "main"} <= added
    for rel, names in LAUNCH_ADDED.items():
        assert names <= _module_functions(port / rel), rel
        added |= names
    # ``main`` is every launch module's CLI entry, as in the reference
    shared = sorted((added & reference) - {"main"})
    assert not shared, f"port functions named like the reference's: {shared}"


def test_analysis_definitions_take_names_of_their_own():
    # the port's lint is a copy of the reference's: every definition in it
    # (function, method, nested helper, class) takes a name no definition
    # of src/repro/ has, but ``main`` (each CLI's entry, as in the launch
    # modules) and ``__init__``, so the reference's lint, which grounds by
    # base name across the whole of src/, sees nothing of it as its own
    # (ROADMAP P2)
    reference = set()
    for path in (ROOT / "src" / "repro").rglob("*.py"):
        reference |= _all_definitions(path)
    assert {"run", "load", "RepoModel", "Finding", "run_analysis",
            "validates", "_collect_scope"} <= reference
    port = set()
    for path in (ROOT / "src" / "repro_torch" / "analysis").glob("*.py"):
        port |= _all_definitions(path)
    assert {"run_axis_threading_torch", "run_host_sync_torch",
            "run_kernel_triples_torch", "run_observability_torch",
            "run_docstrings_torch", "run_analysis_torch", "PortRepoModel",
            "LintFinding", "main"} <= port
    shared = sorted(port & reference - {"main", "__init__"})
    assert not shared, f"lint definitions named like the reference's: " \
                       f"{shared}"
