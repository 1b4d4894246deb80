"""Batched serving engine: continuous batching over prefill/decode steps
with tenant-fair admission — the port of ``repro/serve/engine.py``.

Slot model, as the reference's: a fixed pool of ``max_slots`` decode slots
over a shared preallocated KV cache (batch dim == max_slots). A new
request is prefilled alone and its cache written into a free slot; every
``step()`` admits at most one request per tenant, in weighted-deficit
order (``active / weight``, stable), then advances every slot one token.

Unlike the reference, whose caches are immutable arrays rebuilt on every
step, the port keeps one cache per layer and updates it IN PLACE. An
attention layer's is a (max_slots, max_len, Hkv, D) tensor pair (in
``cfg.cache_dtype`` where set, float8 among them): a prefill writes its
slot's rows, cast into the pool's dtype as the reference's ``astype(pool.
dtype)`` casts them (``common.to_cache_dtype_torch``), a decode step each
slot's row at its position.
``pos`` advances for every slot, free ones too, as in the reference; a slot
past ``max_len`` writes nothing. A mamba layer's is its conv tail and SSM
state per slot: a prefill replaces the slot's whole, with the conv tail
right-aligned (zeros first) after a prompt shorter than ``ssm_conv - 1``,
as the model's causal conv sees it. The reference's engine pads that tail
at the end instead (``repro/serve/engine.py:95-98``), so after a 1- or
2-token prompt its next logits differ from its own model's; the port
follows the model.

Prefills take the model's default positions (under M-RoPE, qwen2_vl_72b,
(3, 1, S) with t == h == w) and decode steps each slot's position, which
the model broadcasts to the three M-RoPE components; as the reference's
engine, it passes no frontend embeddings, so the stub frontends' models
serve token ids.

``stats`` keeps host-clock totals of the prefills and decode steps; each
ends in the host read of its argmax, so the clock covers the device work.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..models.common import to_cache_dtype_torch
from ..models.config import ModelConfig
from ..models.model import (forward_decode, forward_prefill, init_caches,
                            init_params)


@dataclasses.dataclass
class Request:
    rid: int
    tenant: str
    prompt: List[int]
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params=None, max_slots: int = 8,
                 max_len: int = 128,
                 tenant_weights: Optional[Dict[str, float]] = None,
                 seed: int = 0, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = (params if params is not None
                       else init_params(cfg, seed, device=self.device))
        self.max_slots = max_slots
        self.max_len = max_len
        self.caches = init_caches(cfg, max_slots, max_len, device=self.device)
        self.free_slots = list(range(max_slots))
        self.active: Dict[int, Request] = {}
        self.queues: Dict[str, deque] = {}
        self.tenant_weights = tenant_weights or {}
        self.pos = torch.zeros((max_slots,), dtype=torch.int32,
                               device=self.device)   # per-slot next index
        self._next_rid = 0
        self.completed: List[Request] = []
        self._steps = 0
        self.stats = {"prefills": 0, "prefill_tokens": 0, "prefill_s": 0.0,
                      "decode_steps": 0, "decode_tokens": 0, "decode_s": 0.0}

    # -- admission -----------------------------------------------------------
    def submit(self, tenant: str, prompt: List[int],
               max_new_tokens: int = 16) -> int:
        if not 0 < len(prompt) <= self.max_len:
            raise ValueError(f"prompt of {len(prompt)} tokens; the cache "
                             f"holds 1..{self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        self.queues.setdefault(tenant, deque()).append(
            Request(rid, tenant, list(prompt), max_new_tokens))
        return rid

    def _admit_order(self) -> List[str]:
        """Tenants with queued requests, ordered by deficit: active slots
        over weight, lowest first; ties keep submission order (a stable
        sort), as the reference's."""
        active_per = {t: 0 for t in self.queues}
        for r in self.active.values():
            active_per[r.tenant] = active_per.get(r.tenant, 0) + 1

        def deficit(t):
            return active_per.get(t, 0) / self.tenant_weights.get(t, 1.0)
        return sorted((t for t in self.queues if self.queues[t]),
                      key=deficit)

    # -- engine step -----------------------------------------------------------
    def _prefill_into_slot(self, req: Request):
        t0 = time.perf_counter()
        slot = self.free_slots.pop()
        n = len(req.prompt)
        logits, caches = forward_prefill(self.cfg, self.params, [req.prompt],
                                         device=self.device)
        for pool, one in zip(self.caches, caches):
            if "k" in pool:
                for key in ("k", "v"):
                    pool[key][slot, :n] = to_cache_dtype_torch(
                        one[key][0], pool[key].dtype)
                    pool[key][slot, n:] = 0
            else:       # the tail arrives right-aligned (models/ssm.py)
                for key in ("conv", "ssm"):
                    pool[key][slot] = one[key][0]
        req.slot = slot
        req.out_tokens.append(int(logits[0].argmax()))
        self.active[req.rid] = req
        self.pos[slot] = n
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += n
        self.stats["prefill_s"] += time.perf_counter() - t0

    def step(self):
        """One engine iteration: admit at most one request per tenant, then
        one decode step for every slot."""
        for tenant in self._admit_order():
            if self.free_slots and self.queues[tenant]:
                self._prefill_into_slot(self.queues[tenant].popleft())
        if not self.active:
            return
        t0 = time.perf_counter()
        # free slots decode token 0 into their own lanes; ignored
        tokens = [0] * self.max_slots
        for r in self.active.values():
            tokens[r.slot] = r.out_tokens[-1]
        logits, self.caches = forward_decode(
            self.cfg, self.params, self.caches,
            torch.tensor(tokens, device=self.device), self.pos,
            device=self.device)
        self.pos += 1
        self._steps += 1
        nxt = logits.argmax(dim=-1).tolist()
        finished = []
        for r in self.active.values():
            r.out_tokens.append(nxt[r.slot])
            if len(r.out_tokens) >= r.max_new_tokens:
                r.done = True
                finished.append(r.rid)
        self.stats["decode_steps"] += 1
        self.stats["decode_tokens"] += len(self.active)
        self.stats["decode_s"] += time.perf_counter() - t0
        for rid in finished:
            r = self.active.pop(rid)
            self.free_slots.append(r.slot)
            self.completed.append(r)

    def run(self, max_steps: int = 64) -> List[Request]:
        for _ in range(max_steps):
            if not self.active and not any(self.queues.values()):
                break
            self.step()
        return self.completed
