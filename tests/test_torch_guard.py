"""Boundary guards of the port: it imports neither ``jax`` nor anything of
``repro``; its entry points run on the card unless asked for the CPU; its
CUDA wrappers import on any machine and reach ``nvcc``/``ctypes`` only for
CUDA tensors."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.psdsf_fill import kernel as fill_kernel
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
    prob = fig1_instance()
    g = gamma_matrix(prob)
    calls = [
        lambda: resolve_device(),
        lambda: engine.solve(prob),
        lambda: psdsf_solve_torch(prob.demands, prob.capacities,
                                  prob.weights, g),
        lambda: solve_psdsf_rdm_torch(prob),
        lambda: min_vds_guarded(np.ones((3, 2)), prob.weights, g,
                                np.ones(3, bool)),
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
    for name in ("psdsf_fill", "psdsf_vds"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert "extern \"C\"" in src and "Replaces the TPU kernel" in src
        (tmp_path / f"{name}.cu").write_text(src)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("psdsf_fill")
    assert before.parent.name == "kernels" and before.parent.parent.name \
        == "build"
    (tmp_path / "psdsf_fill.cu").write_text(src + "\n// edited\n")
    assert _build.library_path("psdsf_fill") != before
