"""The port's checkpoint manager (``repro_torch.ckpt``): bit-exact
round trips in float32, bfloat16 and int64 (a ``Transformer``'s state
restored in place), the reference's error classes, retention and atomic
publish, a snapshot that does not alias the live state, and directories
written by the reference's ``CheckpointManager`` read bit for bit (its own
restore of a bfloat16 leaf into a target fails: R6)."""
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as RefCheckpointManager
from repro_torch.ckpt import CheckpointManager
from repro_torch.ckpt import manager as manager_mod
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, global_batch_at_torch
from repro_torch.models.model import init_params
from repro_torch.train import (OptimizerConfig, build_train_step_torch,
                               make_train_state_torch)


def _tensor(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int64:
        return torch.randint(-2**62, 2**62, shape, generator=g,
                             dtype=torch.int64)
    return (torch.randn(shape, generator=g) * 1e3).to(dtype)


def _bits(t):
    """A tensor's raw words, for bit-exact comparison (NaN-safe)."""
    return t.reshape(-1).contiguous().view(torch.uint8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int64], ids=str)
def test_roundtrip_is_bit_exact(tmp_path, dtype):
    state = {"a": _tensor(dtype, (3, 5), 0),
             "nested": {"b": _tensor(dtype, (7,), 1),
                        "s": _tensor(dtype, (), 2)}}
    state["a"][0, 0] = float("nan") if dtype.is_floating_point else 0
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, state, block=True)
    index = json.loads((tmp_path / "step_4" / "index.json").read_text())
    assert set(index["leaves"]) == {"a", "nested/b", "nested/s"}
    assert {m["dtype"] for m in index["leaves"].values()} == {
        str(dtype).removeprefix("torch.")}
    out = mgr.restore(4)
    assert out.keys() == index["leaves"].keys()
    for key, want in (("a", state["a"]), ("nested/b", state["nested"]["b"]),
                      ("nested/s", state["nested"]["s"])):
        assert out[key].dtype == dtype and out[key].shape == want.shape
        assert torch.equal(_bits(out[key]), _bits(want)), key
    target = {"a": torch.zeros(3, 5, dtype=dtype),
              "nested": {"b": torch.zeros(7, dtype=dtype),
                         "s": torch.zeros((), dtype=dtype)}}
    keep = target["nested"]["b"]
    assert mgr.restore(4, target=target) is target
    assert target["nested"]["b"] is keep
    assert torch.equal(_bits(target["a"]), _bits(state["a"]))
    assert torch.equal(_bits(keep), _bits(state["nested"]["b"]))


def test_bfloat16_files_use_the_reference_descr(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(3, dtype=torch.bfloat16)}, block=True)
    raw = (tmp_path / "step_1" / "w.npy").read_bytes()
    assert b"'descr': '<V2'" in raw
    # numpy reads the words back (as the reference's manager would)
    arr = np.load(tmp_path / "step_1" / "w.npy")
    assert arr.dtype.itemsize == 2
    np.testing.assert_array_equal(arr.view(np.uint16), [16256] * 3)


def _train_state(seed=0):
    cfg = get_smoke_config("qwen3_1_7b")
    oc = OptimizerConfig(peak_lr=1e-2, warmup_steps=1, decay_steps=10)
    state = make_train_state_torch(cfg, init_params(cfg, seed, device="cpu"),
                                   oc, device="cpu")
    step = build_train_step_torch(cfg, oc, device="cpu")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    return state, step, lambda i: global_batch_at_torch(data, i, "cpu")


def _leaves(state):
    return {k: t.clone() for k, t in manager_mod._flatten_state_torch(state)}


def test_train_state_restores_in_place(tmp_path):
    state, step, batch = _train_state()
    state, _ = step(state, batch(0))
    want = _leaves(state)
    assert {"params/embed", "opt/mu/embed", "opt/nu/embed",
            "opt/step"} <= want.keys()
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, block=True)
    fresh, _, _ = _train_state(seed=5)
    model = fresh["params"]
    wq = model.layers[0].attn.wq
    assert not torch.equal(wq, state["params"].layers[0].attn.wq)
    restored = mgr.restore(1, target=fresh)
    assert restored["params"] is model and model.layers[0].attn.wq is wq
    assert wq.requires_grad
    got = _leaves(restored)
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(_bits(got[key]), _bits(want[key])), key
    assert int(restored["opt"]["step"]) == 1


def test_snapshot_does_not_alias_the_live_state(tmp_path, monkeypatch):
    """Save at step k, run one more step before the writer thread writes,
    wait, restore: step k's values, not step k + 1's."""
    state, step, batch = _train_state()
    state, _ = step(state, batch(0))
    want = _leaves(state)
    stepped = threading.Event()
    write = CheckpointManager._write

    def late_write(self, *args):
        assert stepped.wait(timeout=60)
        write(self, *args)
    monkeypatch.setattr(CheckpointManager, "_write", late_write)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    state, _ = step(state, batch(1))
    stepped.set()
    mgr.wait()
    assert int(state["opt"]["step"]) == 2
    got = mgr.restore(1)
    assert not torch.equal(got["params/embed"], state["params"].embed)
    for key in want:
        assert torch.equal(_bits(got[key]), _bits(want[key])), key


def test_tampered_file_raises_ioerror(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    state = {"a": torch.arange(12.0).reshape(3, 4),
             "nested": {"b": torch.ones((2, 2), dtype=torch.int32)}}
    mgr.save(5, state, block=True)
    victim = tmp_path / "step_5" / "a.npy"
    victim.write_bytes(b"corrupted" + victim.read_bytes()[9:])
    with pytest.raises(IOError, match="checksum"):
        mgr.restore(5, target=state)
    with pytest.raises(IOError, match="checksum"):
        mgr.restore(5)


def test_missing_leaf_and_wrong_shape(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"a": torch.zeros(3), "b": torch.ones(2)}, block=True)
    target = {"a": torch.full((3,), 7.0), "c": torch.zeros(2)}
    with pytest.raises(KeyError, match="missing leaf c"):
        mgr.restore(1, target=target)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, target={"a": torch.zeros(4)})
    # both are refused before any leaf is written
    assert torch.equal(target["a"], torch.full((3,), 7.0))


def test_retention_and_atomic_publish(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    state = {"a": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        mgr.save(s, state, block=(s == 4))
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert not list(tmp_path.glob(".tmp_step_*"))
    assert CheckpointManager(str(tmp_path / "new")).latest_step() is None


def test_writer_error_surfaces_at_wait(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise OSError("disk full")
    mgr = CheckpointManager(str(tmp_path))
    monkeypatch.setattr(mgr, "_write", broken)
    mgr.save(1, {"a": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                      # reported once
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, {"a": torch.zeros(2)}, block=True)


def _reference_state():
    rng = np.random.default_rng(11)
    return {"params": {"w": jnp.asarray(rng.standard_normal((4, 6)),
                                        jnp.bfloat16),
                       "v": jnp.asarray(rng.standard_normal(5),
                                        jnp.float32)},
            "opt": {"step": jnp.asarray(3, jnp.int32)}}


def test_reads_reference_directories_bit_for_bit(tmp_path):
    state = _reference_state()
    RefCheckpointManager(str(tmp_path)).save(2, state, block=True)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 2
    out = mgr.restore(2)
    assert out.keys() == {"params/w", "params/v", "opt/step"}
    assert out["params/w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["params/w"].view(torch.int16).numpy(),
        np.asarray(state["params"]["w"]).view(np.int16))
    np.testing.assert_array_equal(out["params/v"].numpy(),
                                  np.asarray(state["params"]["v"]))
    assert out["opt/step"].dtype == torch.int32 and int(out["opt/step"]) == 3
    target = {"params": {"w": torch.zeros(4, 6, dtype=torch.bfloat16),
                         "v": torch.zeros(5)},
              "opt": {"step": torch.zeros((), dtype=torch.int64)}}
    mgr.restore(2, target=target)
    assert torch.equal(target["params"]["w"], out["params/w"])
    assert int(target["opt"]["step"]) == 3
    # and the reference reads the port's files
    mgr.save(3, target, block=True)
    back = RefCheckpointManager(str(tmp_path)).restore(3)
    np.testing.assert_array_equal(back["params/v"],
                                  np.asarray(state["params"]["v"]))
    np.testing.assert_array_equal(back["params/w"].view(np.int16),
                                  np.asarray(state["params"]["w"])
                                  .view(np.int16))


def test_reference_cannot_restore_its_own_bfloat16_leaf(tmp_path):
    """R6: the reference saves a bfloat16 leaf as '<V2' words and its
    ``restore(..., target=)`` has no cast from them (``manager.py:133``)."""
    state = _reference_state()
    mgr = RefCheckpointManager(str(tmp_path))
    mgr.save(2, state, block=True)
    with pytest.raises(ValueError, match="No cast function"):
        mgr.restore(2, target=state)
