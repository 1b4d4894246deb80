"""The port's training loop (``repro_torch.train.trainer`` and the
launcher ``repro_torch.launch.train``) against the reference's
(``repro.train.trainer.Trainer``, its jitted step) in float32 on the CPU:
both trainers start from the reference's initial params (carried across
with ``convert.params_from_numpy``) and read the same token stream, and
their per-step losses agree to 1e-4 x |reference| (the train step tests'
bound; eps 1e-3 for the reason ``tests/test_torch_train_step.py`` gives).
A restart from a checkpoint repeats the first run's losses exactly: the
restore is bit-exact and the CPU step deterministic."""
import dataclasses
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.data import DataConfig as RefDataConfig
from repro.train import OptimizerConfig as RefOptimizerConfig
from repro.train.trainer import Trainer as RefTrainer
from repro.train.trainer import TrainerConfig as RefTrainerConfig
from repro_torch.data import DataConfig
from repro_torch.launch import train as launch_train
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import load_params, params_from_numpy
from repro_torch.train import (OptimizerConfig, Trainer, TrainerConfig,
                               make_train_state_torch)

BOUND = 1e-4
OC = dict(peak_lr=3e-3, warmup_steps=5, decay_steps=40, clip_norm=1.0,
          eps=1e-3)


def _loop(arch, steps, ckpt_dir, ckpt_every=100):
    cfg = get_smoke_config(arch)
    kw = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tc = dict(total_steps=steps, ckpt_every=ckpt_every, log_every=100)
    ref = RefTrainer(cfg, RefOptimizerConfig(**OC),
                     RefTrainerConfig(ckpt_dir=str(ckpt_dir / "ref"), **tc),
                     RefDataConfig(**kw))
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    port = Trainer(pcfg, OptimizerConfig(**OC),
                   TrainerConfig(ckpt_dir=str(ckpt_dir / "port"), **tc),
                   DataConfig(**kw), device="cpu")
    return ref, port, pcfg


@pytest.mark.parametrize("arch,steps", [("qwen3_1_7b", 10),
                                        ("mamba2_1_3b", 3)])
def test_losses_match_reference_trainer(tmp_path, arch, steps):
    ref, port, pcfg = _loop(arch, steps, tmp_path)
    ref.init_or_restore()
    # before the reference runs: its jitted step donates the state
    params = load_params(pcfg, params_from_numpy(
        pcfg, jax.tree.map(np.asarray, ref.state["params"])), device="cpu")
    port.state = make_train_state_torch(pcfg, params, port.oc, device="cpu")
    want = ref.run()["losses"]
    got = port.run()["losses"]
    assert len(got) == len(want) == steps
    for i, (g, w) in enumerate(zip(got, want)):
        assert abs(g - w) <= BOUND * abs(w), (i, g, w)
    assert port.ckpt.all_steps() == [steps]
    assert len(port.straggler.times["worker0"]) == steps


def _smoke_trainer(ckpt_dir, steps=20, ckpt_every=10, hooks=None):
    cfg = get_smoke_config("qwen3_1_7b")
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    return Trainer(pcfg, OptimizerConfig(**OC),
                   TrainerConfig(total_steps=steps, ckpt_every=ckpt_every,
                                 log_every=100, ckpt_dir=str(ckpt_dir)),
                   DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                              global_batch=4),
                   hooks=hooks, device="cpu")


def test_loss_decreases_and_restart_is_exact(tmp_path):
    seen = []
    first = _smoke_trainer(tmp_path / "run",
                           hooks=lambda s, st, m: seen.append(
                               (s, int(st["opt"]["step"]), float(m["loss"]))))
    out = first.run()
    assert out["final_step"] == 20 and len(out["losses"]) == 20
    assert [s for s, _, _ in seen] == list(range(20))
    assert [k for _, k, _ in seen] == list(range(1, 21))
    assert [loss for _, _, loss in seen] == out["losses"]
    assert np.mean(out["losses"][-5:]) < np.mean(out["losses"][:5])
    assert first.ckpt.all_steps() == [10, 20]
    # wipe the step-20 checkpoint to force restore from 10
    shutil.rmtree(tmp_path / "run" / "step_20")
    second = _smoke_trainer(tmp_path / "run")
    assert second.init_or_restore() == 10
    assert int(second.state["opt"]["step"]) == 10
    out2 = second.run()
    assert out2["losses"] == out["losses"][10:]
    for name, p in first.state["params"].named_parameters():
        assert torch.equal(p, dict(second.state["params"]
                                   .named_parameters())[name]), name


def test_non_finite_loss_raises(tmp_path):
    trainer = _smoke_trainer(tmp_path, steps=3)
    step_fn = trainer.step_fn

    def poisoned(state, batch):
        state, metrics = step_fn(state, batch)
        metrics["loss"] = torch.tensor(float("nan"))
        return state, metrics
    trainer.step_fn = poisoned
    with pytest.raises(FloatingPointError, match="diverged at step 0"):
        trainer.run()


def test_launcher_runs_and_resumes(tmp_path, capsys):
    argv = ["--arch", "qwen3_1_7b", "--smoke", "--steps", "4", "--seq-len",
            "16", "--global-batch", "2", "--device", "cpu", "--ckpt-dir",
            str(tmp_path)]
    out = launch_train.main(argv)
    assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"]))
    assert sorted(p.name for p in tmp_path.glob("step_*")) == [
        "step_2", "step_3", "step_4"]
    text = capsys.readouterr().out
    assert "device: cpu" in text and "starting at step 0" in text
    again = launch_train.main(argv[:4] + ["6"] + argv[5:])
    assert len(again["losses"]) == 2
    assert "starting at step 4" in capsys.readouterr().out


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_cuda, tmp_path):
    cfg = ModelConfig(**dataclasses.asdict(get_smoke_config("qwen3_1_7b")))
    calls = [
        lambda: Trainer(cfg, OptimizerConfig(), TrainerConfig(
            ckpt_dir=str(tmp_path)), DataConfig(cfg.vocab_size, 8, 2)),
        lambda: launch_train.main(["--smoke", "--steps", "1", "--ckpt-dir",
                                   str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
