"""The port's data pipeline (``repro_torch.data``) against the reference's
(``repro.data``): the same (seed, step, shard) draws the same tokens, bit
for bit, for every step and shard count; batches are int64 tensors on the
requested device."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticTokenPipeline as RefPipeline
from repro.data import global_batch_at
from repro_torch.data import (DataConfig, SyntheticTokenPipeline,
                              global_batch_at_torch)


def _configs(**kw):
    return RefDataConfig(**kw), DataConfig(**kw)


@pytest.mark.parametrize("step", range(5))
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_global_batch_equals_reference(shards, step):
    ref_cfg, cfg = _configs(vocab_size=1000, seq_len=24, global_batch=8,
                            seed=7, num_shards=shards)
    want = global_batch_at(ref_cfg, step)
    got = global_batch_at_torch(cfg, step, device="cpu")
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int64
        assert got[key].device.type == "cpu"
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))


@pytest.mark.parametrize("shard_id", [0, 1, 2])
def test_shard_batch_equals_reference(shard_id):
    ref_cfg, cfg = _configs(vocab_size=151936, seq_len=16, global_batch=6,
                            num_shards=3, shard_id=shard_id)
    for step in (0, 9, 123456):
        want = RefPipeline(ref_cfg).batch_at(step)
        got = SyntheticTokenPipeline(cfg, device="cpu").batch_at(step)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


def test_deterministic_shard_disjoint_and_next_token_labels():
    cfg = DataConfig(vocab_size=1000, seq_len=64, global_batch=8,
                     num_shards=2, shard_id=0)
    p0 = SyntheticTokenPipeline(cfg, device="cpu")
    p0b = SyntheticTokenPipeline(cfg, device="cpu")
    p1 = SyntheticTokenPipeline(dataclasses.replace(cfg, shard_id=1),
                                device="cpu")
    b0 = p0.batch_at(7)
    assert torch.equal(b0["tokens"], p0b.batch_at(7)["tokens"])
    assert not torch.equal(b0["tokens"], p1.batch_at(7)["tokens"])
    assert torch.equal(b0["labels"][:, :-1], b0["tokens"][:, 1:])
    assert b0["tokens"].shape == (4, 64)
    first = next(iter(p0))
    assert torch.equal(first["tokens"], p0.batch_at(0)["tokens"])


def test_global_batch_must_divide_by_shards():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=6,
                     num_shards=4)
    with pytest.raises(ValueError, match="divide by num_shards"):
        SyntheticTokenPipeline(cfg, device="cpu")
    with pytest.raises(ValueError, match="divide by num_shards"):
        global_batch_at_torch(cfg, 0, device="cpu")


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_cuda):
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=4)
    for call in (lambda: SyntheticTokenPipeline(cfg),
                 lambda: global_batch_at_torch(cfg, 0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
