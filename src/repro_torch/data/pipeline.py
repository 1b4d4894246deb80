"""Deterministic, restart-safe synthetic token pipeline: the port of
``repro/data/pipeline.py``.

Every batch is a pure function of (seed, step, shard): the tokens come from
numpy's ``default_rng((seed, step, shard_id))`` and the same ``rng.choice``
over the same Zipf unigram distribution as the reference's, so they equal
its tokens bit for bit. Only the container differs: batches are int64
tensors (what ``forward_train_torch`` takes) on the pipeline's device, the
card by default.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    num_shards: int = 1      # data-parallel host shards
    shard_id: int = 0


def _batch_from_tokens_torch(toks: np.ndarray, device: torch.device) -> dict:
    """(B, S + 1) token ids -> {"tokens", "labels"} (B, S) int64 on
    ``device``, the labels the next tokens."""
    t = torch.from_numpy(toks.astype(np.int64)).to(device)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


class SyntheticTokenPipeline:
    """Zipf-ish synthetic LM stream with next-token labels."""

    def __init__(self, cfg: DataConfig, device: DeviceLike = None):
        if cfg.global_batch % cfg.num_shards:
            raise ValueError("global_batch must divide by num_shards")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.per_shard = cfg.global_batch // cfg.num_shards
        # fixed zipf-like unigram distribution (heavy head, long tail)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks
        self._probs = probs / probs.sum()

    def tokens_for(self, step: int) -> np.ndarray:
        """The shard's (per_shard, seq_len + 1) int32 token ids at
        ``step``, the reference's ``_tokens_for``."""
        rng = np.random.default_rng(
            (self.cfg.seed, step, self.cfg.shard_id))
        return rng.choice(
            self.cfg.vocab_size, p=self._probs,
            size=(self.per_shard, self.cfg.seq_len + 1)).astype(np.int32)

    def batch_at(self, step: int) -> dict:
        """The shard-local batch for a given global step (step-addressable)."""
        return _batch_from_tokens_torch(self.tokens_for(step), self.device)

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def global_batch_at_torch(cfg: DataConfig, step: int,
                          device: DeviceLike = None) -> dict:
    """The full global batch (all shards, in shard order) at ``step`` on
    ``device``: one host-to-device copy of the shards' tokens."""
    dev = resolve_device(device)
    toks = np.concatenate([
        SyntheticTokenPipeline(dataclasses.replace(cfg, shard_id=s),
                               device="cpu").tokens_for(step)
        for s in range(cfg.num_shards)], axis=0)
    return _batch_from_tokens_torch(toks, dev)
