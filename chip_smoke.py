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
   gamma), and times both with CUDA events: a kernel (and a library call)
   around the replay of a CUDA graph of many warm calls, which leaves out
   the host's time to launch them, and again back to back; the plain
   version back to back;
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
7. drives the churn loop on the pin, counts set to 0 again: a
   ``ChurnSimulator`` (``layout="auto"``, which must resolve to the buckets;
   Jacobi rounds, bisect fill, 32 rounds at tol 1e-6, float32) stepped to
   the t = 0 equilibrium and then through ``poisson_churn_events`` (horizon
   12, 40 arrivals and 40 departures a tick, degrade rate 0.25, seed 2);
   checks that the bucketed kernel launched 5 x the records' rounds and the
   VDS kernel once a record, prints the ticks' solve times, rounds, events
   and walls, holds the run against the same stream driven with the plain
   versions and against a run on the dense layout (the dense kernel), and
   profiles one more tick for the device-time breakdown;
8. drives the tick layer on the pin: ``DistributedPSDSF`` (float32, bisect
   fill, ``layout="auto"``) for one full tick, a departure and a tick over
   the departed user's servers, then ``min_vds`` (one VDS launch), held
   against the same calls on the CPU;
9. drives ``psdsf_resolve_batched`` over four scenarios of the pin, each
   with one server degraded to 0.5 and its restricted sweep over that
   server and the servers its users are eligible on, warm from the float64
   fixed point of step 4 (bucketed, Jacobi, bisect): the bucketed kernel
   must launch 5 x the rounds, and each scenario must equal its own
   unbatched warm-started solve (the same two phases through the bucketed
   core) to 1e-9 with equal round counts;
10. drives ``placement="headroom"`` on the pin: ``engine.solve(pin,
   "psdsf-rdm", placement="headroom")`` in float64 on the dense layout
   (Jacobi rounds of the bisect fill, 32 at tol=0 for the level solve and
   each refill), its wall split into the level solve, the repack passes
   and the refills, ``psdsf_fill`` launched 5 x all their rounds; held
   against the same solve with the plain versions patched in (1e-9, equal
   rounds), then one repack pass and its refill profiled (device trace
   only) on a 5,000 x 256 cut of the generator;
11. drives the baselines on the pin: ``engine.solve`` for tsf, cdrf and
   cdrfh at level placement (float64, Jacobi, bisect, 32 rounds at tol=0)
   on the dense layout and on the buckets, each held against its
   plain-driven solve (1e-9, equal rounds) with 5 x 32 launches of the
   layout's fill kernel; the routed headroom fill of tsf at the pin (no
   kernel; held against the CPU on a 2,000 x 64 cut); one tsf level solve
   profiled;
12. drives ``ChurnSimulator(pin, mechanism="tsf")`` (float32, buckets,
   Jacobi, bisect) over t = 0 and the first 4 ticks of step 7's stream:
   bucketed launches 5 x the rounds, one VDS launch a record; held against
   the plain-driven stream (rounds equal, per-user totals and min_vds
   within PATH_F32_REL, bottleneck servers tie-aware; a baseline's split
   across a user's servers is not pinned by its fixed point, so it is
   printed, not held); one more tick profiled;
13. drives ``placement="lexmm"`` on a 2,000 x 64 cut of the pin's generator
   (the router's LPs run on the host): ``engine.solve`` for tsf, cdrfh and
   cdrf (no kernel), each held to the one-shot cold router (per-user
   totals within 1e-6, equal stages; the cold routes run in a pool of
   three processes beside the warm solves) and checked feasible, with the
   LP path that ran (scipy's direct HiGHS wrapper or public ``linprog``);
   ``ChurnSimulator(cut, "tsf", placement="lexmm")`` over t = 0 and 4
   ticks of a seeded stream, one ``psdsf_vds`` launch a record, held
   against the plain-driven stream (router fields equal, per-user totals
   and min_vds within PATH_F32_REL, bottleneck servers tie-aware); and
   ``DistributedPSDSF(cut).routed_allocation("tsf")`` across a departure,
   an arrival and no change (modes warm, incremental, fallback, verify);
14. drives the scheduler layers on seeded fleets of 20,000 jobs on 256
   pods and 20,000 tenants on 256 replica groups: ``schedule_detail``
   (float64, Jacobi rounds of the bisect fill, ``SCHED_ROUNDS``) on the
   dense layout, on the buckets and at ``layout="auto"``, 6 launches of
   the layout's fill kernel a round, each held against its plain-driven
   twin and dense against bucketed (1e-9, equal rounds);
   ``admitted_rates`` the same way on the dense layout (4 launches a
   round); ``DynamicDispatcher`` (float32, bisect) for three full ticks
   with tenant departures, on the card and on the CPU, and its
   ``min_vds`` against the plain version; one ``schedule_detail``
   profiled for the idle share;
14a. "properties": solves the pin for psdsf-rdm and psdsf-tdm with
   ``engine.solve`` (float64, Jacobi rounds of the bisect fill, the
   buckets) until ``SolveInfo.converged`` at tol 1e-9 within 256 rounds
   and checks every checker of ``core/properties.py`` that the reference
   tests' guarantee matrix lists for it (and Theorem 1's bottleneck
   structure for RDM) at the reference tests' tolerance, max(1e-5, 10 x
   residual), printing each verdict with its margin and its time; one
   rule for every solve: the verdicts gate where the solve reached its
   tol, and an iterate stopped in the loose band (no fixed point) has
   them printed, not gated; gates drf's and uniform's; times the envy
   check's float64 product against its bound at the float64 tensor-core
   rate; plants one violation of each kind (a server over capacity, a
   user below its uniform share, an envied user, a server whose time
   shares sum below 1, users with no bottleneck) in a copy of the pin's
   allocations, each caught at the planted index; holds every checker on
   the card against the same checker on the CPU on a 2,000 x 64 cut
   (equal verdicts, texts and offenders); the bucketed fill's launches 5
   x the RDM rounds plus the TDM rounds, one ``psdsf_vds`` launch a
   Pareto check;
14b. "gamma-direct": Section IV's co-processor scenario at the pin's
   scale (the pin's gamma; an eighth of the servers get a co-processor a
   quarter of the users can use at 4x): ``solve_psdsf_gamma_tdm_torch``
   with Jacobi rounds of the bisect fill, 32 at tol 0, on the dense layout
   and on the buckets (one TDM event of the layout's fill kernel a round),
   each held against its plain-driven solve (1e-9, equal rounds); then
   Anderson-mixed rounds to tol 1e-6 x max gamma, certified by the TDM
   feasibility, sharing-incentive and Pareto checkers; then one TDM event
   of ``psdsf_fill`` against its plain version, timed beside its bound;
15. holds the attention kernels against their plain versions at
   qwen3_1_7b's widths (16 query and 8 kv heads, head_dim 128, bfloat16):
   ``flash_attention`` at S 1,024, a ragged S 1,000, 512 and 128 (each call
   must take its Hopper body: TMA and wgmma), ``decode_attention`` over 8
   slots of a 2,048-row cache with one length per slot (1, the whole cache,
   past the cache, ragged) and over one 32,768-row cache; times each kernel
   and ``F.scaled_dot_product_attention``, a yardstick the port never
   calls, in turns (kernel, SDPA, SDPA, kernel); then times the Hopper
   flash body at both of its block sizes (64 and 128 query rows) at S 128
   to 1,024 beside the one its wrapper picks, and at gemma_2b's 8/1 x 256
   (its one layout at head dim 256: 64-row blocks and kv stages) in turns
   with the CUDA-core body it replaced, S 128 to 2,048; and the decode
   kernel's tensor-core body at chunks of 64 to 2,048 rows at gemma_2b's
   and qwen2_5_32b's widths beside the chunk its wrapper picks;
15a. holds ``flash_attention`` in float32 (qwen3_1_7b's 16/8 x 128,
   causal, S 1,024, a ragged 1,000, 512 and 128) against its plain version
   at 2e-5, every call on the float32 tensor-core body (split TF32), and
   times it in turns with SDPA in float32 and in turns with the CUDA-core
   body (the wrapper's choice patched; that body is held against the same
   plain at 2e-5 first), beside the bound at the float32-accurate
   tensor-core rate (495 / 3 TFLOP/s);
16. drives the serving path with every launch count set to 0: a
   ``ServingEngine`` on the full qwen3_1_7b config in bfloat16 (params from
   the port's seeded init on the card), 8 slots of 2,048 rows, 16 requests
   from two tenants (gold weight 2, free weight 1) with prompts of 128-1,024
   tokens and 32 new tokens each; checks completion, token ids, finite
   logits and that every prefill launched ``flash_attention`` (its Hopper
   body) and every decode step ``decode_attention`` once per layer; then
   profiles a short serving window for the device's idle share;
17. runs a 2-layer full-width model on the card with the kernels and again
   with the plain versions, on the same params and tokens, and holds the
   prefill and decode logits of the two runs together;
18. holds ``ssd_scan`` against its plain version (float32 on the card) at
   mamba2_1_3b's prefill shape (B 1, S 1,024, 64 heads x 64, N 128, chunk
   128) in bfloat16, at a ragged S 1,000, at S 512 and in float32, called
   as the model calls it (``ops.ssd_chunked`` on slices of one conv
   output, y written through strides): y and the final state; times both
   (no single PyTorch call computes it);
19. drives the Mamba-2 serving path the same way, counts set to 0 again:
   a ``ServingEngine`` on the full mamba2_1_3b config in bfloat16, 8
   slots, the same 16 requests' shape of traffic; checks completion,
   token ids, finite logits and one ``ssd_scan`` launch per layer and
   prefill; profiles a short window for the idle share; then holds a
   2-layer full-width model's logits with the kernel against the plain
   version's;
20. holds the attention kernels against their plain versions, and times
   them in turns with SDPA, at the MoE models' widths (bfloat16):
   granite_moe_3b_a800m's 24 query and 8 kv heads x 64, grok_1_314b's
   48/8 x 128 (GQA groups of 6) and jamba_v0_1_52b's 32/8 x 128, the same
   cases as step 15 (every flash call on the Hopper body);
21. holds the MoE layer's gather routing against its dense GShard
   baseline at granite's widths in float32 (a 1,024-token prefill and an
   8-slot decode step with free slots): equal experts and kept slots,
   outputs within 1e-4 x max(1, max|y|); then ``ssd_scan`` against its
   plain version at jamba's prefill shape (B 1, S 1,024, 128 heads x 64, N
   16, chunk 64) as in step 18;
22. drives the serving path of each MoE model the same way, counts set to
   0 again: granite_moe_3b_a800m whole (32 layers), jamba_v0_1_52b at one
   8-layer group and grok_1_314b at 4 layers (full widths, bfloat16,
   seeded init, the same 16 requests' shape of traffic); checks
   completion, token ids, finite logits and the launches (a flash and a
   decode launch per attention layer and prefill or step, an ``ssd_scan``
   per Mamba layer and prefill); profiles a window for the idle share and
   the MoE layers' share of the busy time; then runs a 2-layer granite, an
   8-layer jamba and a 2-layer grok with the kernels and with the plain
   versions, the plain run's routing forced to the kernels' run's experts
   (a token whose own plain top-k differs must be a near tie: its k-th and
   (k+1)-th probabilities within 2^-4 of the k-th, ``TIE_REL``; such
   tokens at most 2^-4 of those routed), logits within 2^-5 x max|logit|;
23. holds the attention kernels against their plain versions, and times
   them in turns with SDPA, at the dense and frontend configs' widths
   (bfloat16, step 15's cases): qwen2_5_32b 40/8 x 128 (groups of 5),
   granite_3_8b 32/8 x 128, gemma_2b 8/1 x 256 (groups of 8),
   qwen2_vl_72b 64/8 x 128, musicgen_large 32/32 x 64 (every flash call
   on the Hopper body; every decode call at groups of 2-16 on the
   tensor-core body, counted);
24. drives the serving path of each the same way, counts set to 0 again
   (full widths, bfloat16, seeded init, 8 slots of 2,048 rows):
   gemma_2b, granite_3_8b and musicgen_large whole with step 16's 16
   requests; qwen2_5_32b whole (64 layers, 65.5 GB) and qwen2_vl_72b at 32
   of its 80 layers with 8 requests of 16 new tokens (prompts of
   128-1,024), each after the last model is freed and the cache emptied;
   checks completion, token ids, finite logits, one flash launch per layer
   and prefill (on the body its head dim takes) and one decode launch per
   layer and step (on the tensor-core body at groups of 2-16), prints the
   peak device memory, profiles a window for
   the idle share (4 requests of 512 tokens, 4 new tokens each), then
   holds a 2-layer full-width model's logits with the
   kernels against the plain versions' (2^-5 x max|logit|); for
   qwen2_vl_72b and musicgen_large a 2-layer prefill whose first 64
   positions come from ``extra_embeds`` (the vision stub's 8 x 8 patch grid
   with 3-D M-RoPE ids, the audio stub's frames with 1-D positions), the
   kernels' logits against the plain versions' by the same rule;
24a. holds ``flash_attention`` with a sliding window against its plain
   version: on the Hopper body (bf16) qwen3_1_7b's 16/8 x 128 at S 1,024,
   W 256, Mistral-7B-v0.1's 32/8 x 128 at S 8,192, W 4,096 and gemma_2b's
   8/1 x 256; on the float32 tensor-core body qwen3's widths in float32;
   the lse call at S 2,048; each timed in turns with SDPA given the boolean
   window mask and with the kernel without the window, beside the bound
   over the windowed pairs;
24b. holds ``decode_attention`` over e4m3 and e5m2 caches, without and
   with a first valid row per sequence (0, inside the length, equal to
   it), at qwen3_1_7b's and qwen2_5_32b's widths (8 slots x 2,048 rows),
   split into 1, 2 and 4 chunks and the wrapper's own, out and lse against
   the plain version; timed in turns with the bf16-cache kernel on the
   same rows and with SDPA, beside the byte bound at one byte a value;
24c. drives the serving path the same way, counts set to 0 again, on
   full-width qwen3_1_7b with ``sliding_window=256`` and an e4m3 cache
   (every flash and decode launch windowed, every decode launch float8),
   profiles a window, and holds a 2-layer model of that config with the
   kernels against the plain versions (2^-5 x max|logit|);
24d. holds ``decode_attention``'s float32-query, bfloat16-cache entry
   (float32 params over bfloat16 activations), without and with first
   rows, at qwen3_1_7b's and qwen2_5_32b's widths (8 slots x 2,048 rows),
   split into 1, 2 and 4 chunks and the wrapper's own, out and lse against
   the plain version at the float32 entry's bounds; timed in turns with
   SDPA on the float32 q over the cache widened to float32, with the
   float32 entry over that widened cache and with the bfloat16-cache
   kernel on a bfloat16 q, beside the byte bound;
24e. drives the serving path the same way, counts set to 0 again, on
   full-width qwen3_1_7b with float32 params over bfloat16 activations
   (every decode launch on the mixed entry, every prefill on flash's
   float32 tensor-core body), profiles a window, and holds a 2-layer model
   of that config with the kernels against the plain versions (2^-5 x
   max|logit|);
25. holds the flash kernel's log-sum-exp output (``return_lse=True``, the
   training path's forward) against its plain version at qwen3_1_7b's 16/8
   x 128 and gemma_2b's 8/1 x 256, S 2,048, in bfloat16 and float32 (out
   to the kernel bound of step 15, lse to 1e-3 absolute in bfloat16 and
   1e-5 in float32), the float32 calls on the float32 tensor-core body,
   the CUDA-core body held against the same plain at the same bounds and
   timed in turns with it, and times the lse call in
   turns with the serving call (no lse) at qwen3's S 1,024;
26. runs one training step's forward and backward of a 2-layer full-width
   qwen3_1_7b and mamba2_1_3b in float32 (B 2, S 2,048; attention through
   ``_FlashTrain``, the SSD through ``_SsdTrain``), then again with the
   plain versions patched in: the loss and every gradient held together
   to 1e-4 x max|.| (a kernel output with no ``grad_fn`` would drop a
   gradient's share), each kernel launched twice a layer (the recompute);
27. drives the training path with every launch count set to 0: one
   ``build_train_step_torch`` step of full-width qwen3_1_7b (28 layers,
   bfloat16 params, float32 moments, B 2 x S 2,048 in 2 microbatches,
   ``remat="full"``, ``attn_flash_block`` 1,024), after a warm-up step;
   checks a finite loss near ln(151,936), a finite positive grad_norm and
   112 flash launches (28 layers x 2 microbatches x 2), every one on the
   Hopper body with lse; prints the step wall, tokens/s and peak device
   memory, profiles one more step for the idle share, flash's share of
   the busy time and the device and host time of three ranges (each
   microbatch's forward and backward, the plain-torch flash backward in
   it, the AdamW update), and holds the first step's loss and grad_norm against
   the same step from the same params with the plain flash (2^-6 and 2^-4
   relative);
27a. the 2-layer float32 training check of step 26 with a window of 48
   (``_FlashTrain``'s forward through the windowed flash, its backward's
   mask with the window), then one full-width qwen3_1_7b step with a window
   of 1,024: 112 flash launches, each windowed with lse on the Hopper
   body; its loss and wall;
27b. one full-width qwen3_1_7b step with float32 params over bfloat16
   activations (step 27's shapes, float32 moments): 112 flash launches on
   the float32 tensor-core body with lse; its wall, tokens/s and peak device
   memory; then step 26's 2-layer check in that config (every gradient
   float32, 1e-4 x max|.|);
27c. step 27's bfloat16 step under ``remat`` "full", "dots" (a selective
   checkpoint that saves the products with a weight) and "none", each
   from the same seeded params: the walls and peak device memory, which
   must be ordered full <= dots <= none, and the first steps' losses
   within step 27's 2^-6;
28. drives the training loop with every launch count set to 0 before each
   run: ``Trainer`` on full-width qwen3_1_7b (28 layers, the training
   step's shapes) for 3 steps with a checkpoint every 2 into a temporary
   directory (an async save at step 2, the final blocking save at 3);
   deletes step_3; a fresh ``Trainer`` on the directory must resume at
   step 2 with the step-2 snapshot's embedding, a layer's wq, their
   moments and the step equal bit for bit, and repeat step 3's loss
   within 2e-3; checks 4 x 112 flash launches with lse; prints the
   losses, step walls, tokens/s, the checkpoint's bytes, the free disk
   and the seconds to snapshot, write and hash, and restore;
29. drives ``ElasticController`` over step 14's fleet (20,000 jobs x 256
   pods) with the port's ``schedule`` on the card (float64, Jacobi rounds
   of the bisect fill, dense layout, ``SCHED_ROUNDS``) as its solve: the
   initial solve, then 8 pods go silent and ``on_tick`` marks them
   failed and re-solves; 6 ``psdsf_fill`` launches a round; each
   allocation held against the same controller driven with the plain
   versions (1e-9 a job, equal rounds); prints both solve walls and the
   jobs whose replicas fell;
29a. "headdim decode": a 2-layer full-width qwen3_1_7b (bf16, seeded
   init) decodes on a 2 x 2 ("data", "model") mesh of 4 gloo ranks on the
   one card (spawned as step 30's ranks; gloo's all-gathers and the like
   go through host copies, ``host_collectives_for_gloo``): batch 16, a
   2,048-row cache, a 1,024-token prefill and 8 decode steps with the
   cache sharded on its head dim (``decode_cache_shard="headdim"``) and,
   as its twin, on its sequence; each run's logits against the same steps
   unsharded in the main process (flash and the decode kernel) within
   2^-5 x max|logit|, its greedy tokens equal wherever the top two logits
   differ by more; prints the step times, which over gloo through the
   host say nothing of NVLink;
30. "pod mean": ``train/compression.py::compressed_cross_pod_mean_torch``
   on two ranks (a spawn context, a ``file://`` store in a temporary
   directory): NCCL with a card a rank where there are two cards, else
   gloo with both ranks' tensors on ``cuda:0``; each rank's gradients and
   residuals are full-width qwen3_1_7b's parameter shapes (1.72e9 float32
   values each), drawn from a seeded generator per rank on the card; rank
   0 then redraws both ranks' tensors, sums the two error-feedback
   estimates in one process and divides by 2: the mean and its own
   residuals must be equal bit for bit; prints the backend, every
   tensor's device, the seconds and the bytes (no speed claim);
31. "launch dry run": ``python -m repro_torch.launch.dryrun`` in
   subprocesses (started in the background at the lowest priority after
   step 2's build, two chains, each with a timeout): jamba_v0_1_52b, grok_1_314b and
   qwen2_vl_72b at full depth on the single-pod (16, 16) mesh at
   decode_32k, and qwen3_1_7b at train_4k; each result must be ``ok``;
   prints the per-device argument and temp GB against the card's 80 GB,
   the collective counts by kind and the H100 roofline table;
32. "roofline on the card": the dry run (same chains) of exactly step
   27's training step (B 2 x S 2,048, 2 microbatches, remat) and step
   16's decode step (8 slots x 2,048 rows) on a one-rank group and a
   (1, 1) mesh; for each the three roofline terms with the H100
   figures (the traced eager ops' FLOPs and bytes, each kernel call at
   its own inputs, outputs and operations), the wall steps 27 and 16
   measured (not run again), which must not beat the bound, the wall
   over the bound and the model-FLOP utilization (model FLOPs / wall /
   989 TFLOP/s), on one line with the card's name and power limit;
33. prints the ``kernels`` JSON line, the ``nvidia-smi`` line, and as its
   last line ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero without the last line. Without a CUDA device,
or without the repository's ``src/`` beside it, it fails at once. With
``--rehearse`` it runs every phase on the CPU at tiny sizes through the plain
versions (the serving phases on the smoke configs of every arch), skips
what needs the card, and never prints a result line.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import os
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

#: NVIDIA H100 SXM data sheet: HBM3 rate, float32 and float64 rates outside
#: the tensor cores (dense), all at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
#: dense bfloat16 tensor-core rate of the same data sheet, the attention
#: kernels' operations bound (the work they do, whatever units do it)
PEAK_BF16_FLOPS = 989e12
#: the float32-accurate rate of the tensor cores in TF32: dense TF32 (495
#: TFLOP/s, the same data sheet) over the three TF32 products that stand
#: for one float32 product (hi·hi + hi·lo + lo·hi). The bound of float32
#: flash, whose kernel takes its products so; at the CUDA cores' 67 a right
#: kernel would read faster than its bound
PEAK_F32_TC_FLOPS = 495e12 / 3
#: the float32-accurate rate of ssd_scan's float32 entry: its operands are
#: split into bfloat16 hi/lo terms and each product is three bfloat16
#: products, so dense bfloat16 over three
PEAK_F32_SPLIT_BF16_FLOPS = PEAK_BF16_FLOPS / 3

F64_ATOL = 1e-9            # float64 parity bound (tests/test_torch_*.py)
F32_REL = 5e-6             # float32 bound, times max(1, |plain|)
VDS_RTOL = 1e-6            # VDS minimum; argmins must be equal
#: float32 paths on the card vs the same path with the plain versions, on
#: the CPU or on another layout (churn: ~13 re-solves, ~400 Jacobi rounds
#: of float32 fills; tick: one bisect fill a server): each event's kernel
#: agrees with its plain version to a few float32 ulps (F32_REL holds it to
#: 5e-6), and the damped sweep carries such a difference forward without
#: amplifying it, so ~400 rounds of a few ulps (1.2e-7 each) stay under
#: 1e-4 x max(1, max|x|); min_vds (a ratio of x) within 1e-4 relative;
#: round counts, argmins and bottleneck servers equal
PATH_F32_REL = 1e-4
#: attention kernel (bfloat16 out) vs plain version in float32: the kernel
#: rounds its float32 result to bfloat16 once (2^-9 relative) after summing
#: in another order (flash on the tensor cores also rounds the softmax
#: weights to bfloat16, 2^-9 relative each, which averages out over a
#: row); bound 2^-8 x max(1, max|plain|)
ATTN_REL = 2.0 ** -8
#: logits of the 2-layer model, kernels vs plain versions, bfloat16: the
#: runs differ only where the two attentions round to different bfloat16
#: neighbours (1 ulp, 2^-8 relative); two layers and the bfloat16 logit
#: product carry that to a few ulps of the largest logit: bound 4 ulps,
#: 2^-5 x max|logit|
LOGIT_REL = 2.0 ** -5
#: ssd_scan vs plain version in float32 on the same inputs, times
#: max(1, max|plain|): float32 sums in another order (1e-4, the JAX ssd
#: tests' bound); a bfloat16 y is rounded once more (2^-9 relative), bound
#: 2^-8; the final state is float32 in both runs (1e-4)
SSD_REL = {"float32": 1e-4, "bfloat16": 2.0 ** -8}
#: flash's and decode's log-sum-exp outputs (float32 in every body) vs
#: their plain versions: the scores are products of the same inputs summed in float32,
#: so lse is within a few float32 ulps of a row's ~5-10; bounds 1e-3
#: absolute in bfloat16 (its exp2 domain and the Hopper body's tiles), 1e-5
#: in float32
LSE_ATOL = {"bfloat16": 1e-3, "float32": 1e-5}
#: float32 flash output vs plain (tests/test_torch_cuda.py's ATTN_TOL):
#: float32 sums in another order, times max(1, max|plain|)
ATTN_F32_REL = 2e-5
#: a float32 training step's loss and every gradient, kernels vs plain
#: versions (models' float32 bound, ROADMAP "How every slice is held" 3),
#: times max|.| of each
TRAIN_F32_REL = 1e-4
#: the full-width bfloat16 step, kernels vs plain flash from the same
#: params: the two forwards differ where the attentions round to different
#: bfloat16 neighbours (2^-8); 28 layers carry that into the loss (bound
#: 2^-6 relative) and the gradients' norm (2^-4)
TRAIN_BF16_LOSS_REL = 2.0 ** -6
TRAIN_BF16_NORM_REL = 2.0 ** -4
#: the MoE models' kernel-vs-plain runs: the plain run is routed to the
#: experts the kernels' run chose; a token whose own plain top-k differs
#: must be a near tie, its k-th and (k+1)-th plain probabilities within
#: TIE_REL of the k-th, and such tokens at most TIE_REL of those routed.
#: Bound 2^-4: one bfloat16 ulp (2^-8..2^-7 relative) on a third of a
#: 2-layer granite's attention outputs moves its routers' probabilities by
#: a median 1.1% and a 99th percentile 4.8% of the k-th (float32 routers
#: over bfloat16 hidden states; emulated on a CPU), and on an H100 this
#: phase saw tokens move at gaps up to 2.0e-2 (granite) and 2.9e-2 (jamba)
TIE_REL = 2.0 ** -4

KERNELS = ("psdsf_fill", "psdsf_fill_bucketed", "psdsf_vds",
           "flash_attention", "decode_attention", "ssd_scan")


#: the MoE models: the attention kernels run at each one's widths
MOE_ARCHS = ("granite_moe_3b_a800m", "grok_1_314b", "jamba_v0_1_52b")
#: (arch, serving depth, kernel-vs-plain depth): granite whole (32 layers,
#: 6.6 GB in bf16); jamba at one group of its 8-layer pattern (26.5 GB of
#: 102.9) and grok at 4 layers (29.7 GB of 426.8), full widths, until a
#: model can be sharded across cards
MOE_SERVING = (("granite_moe_3b_a800m", None, 2), ("jamba_v0_1_52b", 8, 8),
               ("grok_1_314b", 4, 2))


#: the dense and frontend configs: the attention kernels run at each
#: one's widths (qwen2_5_32b 40/8 x 128, granite_3_8b 32/8 x 128, gemma_2b
#: 8/1 x 256, qwen2_vl_72b 64/8 x 128, musicgen_large 32/32 x 64; flash
#: on the Hopper body at all five, decode on the tensor-core body at
#: groups of 2-16)
DENSE_ARCHS = ("qwen2_5_32b", "granite_3_8b", "gemma_2b", "qwen2_vl_72b",
               "musicgen_large")
#: (arch, serving depth, requests, new tokens a request): gemma, granite and
#: musicgen whole with the 16 requests of 32 tokens; qwen2_5_32b whole (64
#: layers, 65.5 GB) and qwen2_vl_72b at 32 of its 80 layers (61.2 GB of
#: 145.4, until a model can be sharded across cards) with 8 requests of 16,
#: to bound the run's time; full widths
DENSE_SERVING = (("gemma_2b", None, 16, 32), ("granite_3_8b", None, 16, 32),
                 ("musicgen_large", None, 16, 32),
                 ("qwen2_5_32b", None, 8, 16), ("qwen2_vl_72b", 32, 8, 16))
#: their profiled serving windows: 4 requests of 512 prompt tokens, 4 new
#: tokens each (the earlier models' windows are 8 and 8). The profiler's
#: processing grows with the ops it records, layers x passes: 8 and 8 made
#: these five profiles 182 s of a 719 s run on an NVIDIA H100 80GB HBM3
DENSE_PROFILE_WINDOW = (4, 4)


#: per-body launch counts beside ``.launches`` (flash_attention's three)
#: and its lse launches
BODY_COUNTS = ("hopper_launches", "tf32_launches", "cuda_core_launches",
               "lse_launches")
#: the CUDA kernels behind the flash and ssd_scan wrappers, named in the
#: ``kernels`` line: flash's three bodies by their counters' names, and the
#: three kernels of ssd_scan's one body, which takes both dtypes
KERNEL_BODIES = {
    "flash_attention": {
        "hopper": "flash_wgmma_kernel: bfloat16, TMA + wgmma",
        "tf32": "flash_tf32_kernel: float32, split TF32 on mma.sync",
        "cuda_core": "flash_kernel: other head dims and rows, CUDA cores"},
    "ssd_scan": {
        "chunked": "ssd_chunk_kernel, ssd_state_kernel, ssd_output_kernel: "
                   "bfloat16 and float32 (hi/lo bfloat16 splits), mma.sync"}}
#: decode_attention's count of its tensor-core body's launches
DECODE_BODY_COUNTS = ("tc_launches",)
#: the attention wrappers' counts of their windowed and float8 launches
#: (flash_attention: window; decode_attention: first rows, float8 caches)
VARIANT_COUNTS = ("window_launches", "fp8_launches", "mixed_launches")


#: the sliding-window and float8-cache phases: qwen3_1_7b served with a
#: 256-token window (shorter than the 512-token prompts: it cuts in
#: prefill and in decode) and an e4m3 KV cache; the 2-layer float32
#: gradients' window (below the flash block of 1,024 that divides S 2,048)
#: and the full-width training step's
WINDOW_SERVING = {"sliding_window": 256, "cache_dtype": "float8_e4m3fn"}
TRAIN_WINDOW = 48
TRAIN_STEP_WINDOW = 1024
#: Mistral-7B-v0.1's attention from its published config.json (32 heads, 8
#: kv heads, hidden 4,096: head dim 128, "sliding_window": 4096), at S
#: 8,192: (Hq, Hkv, D, W, S)
MISTRAL_ATTN = (32, 8, 128, 4096, 8192)
#: the float8 cache dtypes the decode kernel reads
FP8_CACHES = ("float8_e4m3fn", "float8_e5m2")
# params and activations in different dtypes: float32 params (master
# weights) over bfloat16 activations; the projections promote q, k and v
# to float32, the KV cache stays bfloat16
SPLIT_DTYPES = {"param_dtype": "float32", "dtype": "bfloat16"}
# under it, the gradients that pass through a bfloat16 activation's
# cotangent (rounded, and added in bfloat16), held to two bfloat16
# roundings of their largest value (tests/test_torch_dtype_split.py)
SPLIT_BF16_PATH = ("embed", "layers.0.norm_mixer.scale")
SPLIT_ROUNDED_REL = 2.0 ** -7
# the training step under each remat policy, in the order of their peaks
REMATS = ("full", "dots", "none")


#: the training loop phase: depth of its full-width qwen3_1_7b (None: all
#: 28 layers), and the step-2 snapshot's leaves it keeps on the card to
#: hold the restore against, bit for bit
TRAIN_LOOP_LAYERS = None
TRAIN_LOOP_KEEP = ("params/embed", "params/layers.0.attn.wq", "opt/mu/embed",
                   "opt/nu/embed", "opt/mu/layers.0.attn.wq",
                   "opt/nu/layers.0.attn.wq", "opt/step")
#: the resumed step's loss against the first run's: the reference's own
#: restart bound (tests/test_substrate.py); the card's backward sums with
#: atomics, so a step is not bit-deterministic there
RESTART_RTOL = 2e-3
#: pods that go silent in the elastic re-solve phase
ELASTIC_SILENT = 8

#: Jacobi rounds of the scheduler phase's solves (``schedule_detail`` and
#: ``admitted_rates`` keep ``ensure_converged`` on: a budget the fleet
#: does not converge in raises, and is raised here, never caught)
SCHED_ROUNDS = 32

#: the "properties" phase: the pin's PS-DSF solves (float64, Jacobi
#: rounds of the bisect fill, ``layout="auto"``: the buckets) run to
#: ``SolveInfo.converged`` at tol 1e-9 within ``PROPERTY_ROUNDS``
PROPERTY_TOL = 1e-9
PROPERTY_ROUNDS = 256
#: the reference's property tests' tolerance: max(1e-5, 10 x residual)
PROPERTY_CHECK_TOL = 1e-5
#: the checkers' card-vs-CPU cut of the pin's generator
PROPERTY_CUT = dict(num_users=2000, num_servers=64, cells=4)
#: NVIDIA H100 SXM data sheet: float64 on the tensor cores (DMMA), the
#: rate of the envy check's float64 product
PEAK_F64_TENSOR_FLOPS = 67e12
#: the "gamma-direct" phase: Section IV's co-processor scenario at the
#: pin's scale: an eighth of the servers get a co-processor that a
#: quarter of the users can use at ``extensions.COPROCESSOR_SPEEDUP``;
#: Jacobi rounds of the bisect fill, 32 at tol 0 against the plain-driven
#: solve, then Anderson-mixed rounds to the engine's default tol (1e-6 x
#: max gamma) within ``GAMMA_ROUNDS``
GAMMA_SEED = 31
GAMMA_TOL = 1e-6
GAMMA_ROUNDS = 2048
#: the "headdim decode" phase: a 2-layer full-width qwen3_1_7b in bf16 on
#: a 2 x 2 ("data", "model") mesh of 4 gloo ranks on the one card: batch
#: 16 (``shard_cache_seq_threshold``, so the cache shards on the batch and
#: on its head dim or its sequence), a 2,048-row cache, a 1,024-token
#: prefill and 8 decode steps, seeded params (the port's init) and tokens
HEADDIM_LAYERS = 2
HEADDIM_BATCH = 16
HEADDIM_ROWS = 2048
HEADDIM_PROMPT = 1024
HEADDIM_STEPS = 8
HEADDIM_SEED = 5
HEADDIM_RANKS = 4
HEADDIM_TIMEOUT = 300

#: the launch tooling's phases: the cross-pod mean's ranks, the dry run's
#: cells (two chains of CLI runs) and their time limits (seconds)
POD_RANKS = 2
POD_TIMEOUT = 600
POD_ARCH = "qwen3_1_7b"
DRYRUN_CHAINS = (
    (("jamba_v0_1_52b", "decode_32k", ()),
     ("grok_1_314b", "decode_32k", ()),
     ("qwen2_vl_72b", "decode_32k", ())),
    (("qwen3_1_7b", "train_4k", ()),
     # step 27's training step and step 16's decode step on one device
     ("qwen3_1_7b", "train_4k", ("--mesh-shape", "1x1", "--batch", "2",
                                 "--seq", "2048", "--microbatches", "2",
                                 "--tag", "card")),
     ("qwen3_1_7b", "decode_32k", ("--mesh-shape", "1x1", "--batch", "8",
                                   "--seq", "2048", "--tag", "card"))))
DRYRUN_TIMEOUT = 600
CARD_GB = 80


def cold_route_totals(src, demands, capacities, weights, eligibility,
                      mechanism):
    """Process-pool worker of the lexmm phase: the one-shot cold router's
    per-user totals, stages and wall (s) on the given problem."""
    if src not in sys.path:
        sys.path.insert(0, src)
    from repro_torch.core.baselines_torch import level_rate_matrix_np
    from repro_torch.core.flowrouter import lexmm_route_cold_np
    from repro_torch.core.types import AllocationProblem
    prob = AllocationProblem(demands, capacities, weights, eligibility)
    t0 = time.perf_counter()
    x, stages = lexmm_route_cold_np(prob,
                                    level_rate_matrix_np(prob, mechanism))
    return x.sum(axis=1), stages, time.perf_counter() - t0


def pod_mean_rank(rank, world, init, out_dir, backend, rehearse):
    """A process of the "pod mean" phase: ``compressed_cross_pod_mean_torch``
    over full-width qwen3_1_7b's parameter shapes (smoke shapes in a
    rehearsal), gradients and residuals drawn on the card from a generator
    seeded per rank; rank 0 then holds the mean and its residuals against
    the plain version. Writes ``rank<r>.json`` into ``out_dir``."""
    import datetime
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.models.model import abstract_params_torch
    from repro_torch.train import compression
    if rehearse:
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=POD_TIMEOUT))
    try:
        cfg = (get_smoke_config if rehearse else get_config)(POD_ARCH)
        shapes = {n: tuple(p.shape) for n, p in
                  abstract_params_torch(cfg).named_parameters()}

        def draw(r):
            gen = torch.Generator(device=dev).manual_seed(1000 + r)
            for name, shape in shapes.items():
                g = torch.randn(shape, generator=gen, device=dev)
                res = torch.randn(shape, generator=gen, device=dev) * 0.01
                yield name, g, res
        grads, res = {}, {}
        for name, g, r_ in draw(rank):
            grads[name], res[name] = g, r_
        n = sum(g.numel() for g in grads.values())
        devices = sorted({str(t.device) for t in (*grads.values(),
                                                  *res.values())})
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dist.barrier()
        t0 = time.perf_counter()
        mean, new_res = compression.compressed_cross_pod_mean_torch(grads,
                                                                    res)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        del grads, res
        out = dict(rank=rank, backend=backend, values=n, leaves=len(shapes),
                   input_devices=devices, seconds=seconds,
                   estimate_bytes=4 * n,
                   int8_wire_bytes=4 * n * compression.wire_bytes_ratio_np(),
                   output_devices=sorted({str(t.device) for t in (
                       *mean.values(), *new_res.values())}),
                   peak_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                             if dev.type == "cuda" else None))
        if rank == 0:
            # the plain version: both ranks' estimates in this process,
            # summed on the card and divided by 2
            unequal_mean, unequal_res = [], []
            t0 = time.perf_counter()
            for (name, g0, r0), (_, g1, r1) in zip(draw(0), draw(1)):
                e0, nr0 = compression.ef_compress_decompress_torch(g0, r0)
                e1, _ = compression.ef_compress_decompress_torch(g1, r1)
                if not torch.equal(mean[name], (e0 + e1) / 2):
                    unequal_mean.append(name)
                if not torch.equal(new_res[name], nr0):
                    unequal_res.append(name)
            out.update(unequal_mean=unequal_mean, unequal_res=unequal_res,
                       plain_seconds=time.perf_counter() - t0)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def headdim_config(rehearse):
    """The "headdim decode" phase's model: qwen3_1_7b at full width (its
    smoke config in a rehearsal), ``HEADDIM_LAYERS`` layers, bf16; and
    the same with the mesh's axes set, as the launcher sets them."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config if rehearse else get_config)("qwen3_1_7b")
    cfg = dataclasses.replace(cfg, num_layers=HEADDIM_LAYERS)
    return cfg, dataclasses.replace(cfg, dp_axes=("data",),
                                    tp_axis="model")


def headdim_inputs(cfg, rehearse):
    """(prompt (B, S), the tokens fed at each decode step (steps, B), rows
    of the cache), seeded."""
    import numpy as np
    b, s, steps, rows = ((4, 24, 3, 32) if rehearse else (
        HEADDIM_BATCH, HEADDIM_PROMPT, HEADDIM_STEPS, HEADDIM_ROWS))
    rng = np.random.default_rng(HEADDIM_SEED)
    return (rng.integers(0, cfg.vocab_size, (b, s)),
            rng.integers(0, cfg.vocab_size, (steps, b)), rows)


#: the ``torch.library`` registrations of ``host_collectives_for_gloo``
_HOST_COLLECTIVES = []


def host_collectives_for_gloo():
    """Route the functional collectives DTensor issues on CUDA tensors
    through host copies, in this process: the ranks of "headdim decode"
    share one card over gloo, and gloo's all-gather on CUDA tensors
    (``_allgather_base``) kills the process with a segmentation fault in
    the card's torch (2.11; its all-reduce works). Each CUDA kernel of
    ``_c10d_functional``'s all-gather, reduce-scatter and all-to-all, and
    of DTensor's ``_dtensor.shard_dim_alltoall``, is replaced by the same
    op on a host copy (gloo's CPU path, which the CPU tests run), waited
    for and copied back; the port's code is untouched. With a card a rank
    (NCCL) nothing of this is needed."""
    import torch
    from torch.distributed.distributed_c10d import _resolve_process_group
    ops = torch.ops._c10d_functional

    def on_host(op):
        def run(tensor, *args):
            out = ops.wait_tensor(op(tensor.cpu(), *args))
            return out.to(tensor.device)
        return run

    def shard_dim_alltoall(tensor, gather_dim, shard_dim, group_name):
        group = _resolve_process_group(group_name)
        whole = ops.wait_tensor(ops.all_gather_into_tensor(
            tensor.cpu().contiguous(), group.size(), group_name))
        whole = torch.cat(whole.chunk(group.size()), dim=gather_dim)
        part = whole.chunk(group.size(), dim=shard_dim)[group.rank()]
        return part.contiguous().to(tensor.device)

    if _HOST_COLLECTIVES:
        return
    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name in ("all_gather_into_tensor", "reduce_scatter_tensor",
                 "all_to_all_single"):
        lib.impl(name, on_host(getattr(ops, name).default), "CUDA")
    dtensor = torch.library.Library("_dtensor", "IMPL")
    dtensor.impl("shard_dim_alltoall", shard_dim_alltoall, "CUDA")
    _HOST_COLLECTIVES.extend((lib, dtensor))


def headdim_decode_rank(rank, world, init, out_dir, shards, rehearse):
    """A process of the "headdim decode" phase: the 2-layer model's params
    from the seeded init on the card, sharded on a 2 x 2 mesh over gloo;
    for each ``decode_cache_shard`` value of ``shards``, a sharded prefill,
    then ``HEADDIM_STEPS`` decode steps over a cache laid out by
    ``cache_specs_np`` with it. Writes ``<shard>_rank<r>.json`` (its
    launches and step walls) and, on rank 0, ``<shard>.pt`` (every step's
    logits, gathered); a fault's Python stack goes to ``fault<r>.txt``,
    which the phase prints."""
    import datetime
    import faulthandler
    fault = open(Path(out_dir) / f"fault{rank}.txt", "w")
    faulthandler.enable(file=fault)
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch import sharding as S
    from repro_torch.launch.mesh import make_debug_mesh_torch
    from repro_torch.models import model as tmodel
    if rehearse:
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        host_collectives_for_gloo()
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(
                                seconds=HEADDIM_TIMEOUT))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    try:
        counters = wrappers()
        _, cfg = headdim_config(rehearse)
        prompt, feed, rows = headdim_inputs(cfg, rehearse)
        b, s = prompt.shape
        mesh = make_debug_mesh_torch(2, 2, device_type=dev.type)
        params = tmodel.init_params(cfg, HEADDIM_SEED, device=dev)
        S.distribute_state_torch(cfg, mesh, params)
        for shard in shards:
            reset_counts(counters)
            opts = S.ShardingOptions(decode_cache_shard=shard,
                                     shard_cache_seq_threshold=b)
            tspec = S.token_specs_np(mesh, b, opts)
            walls = []
            with implicit_replication():
                tokens = S.distribute_tensor_torch(
                    torch.as_tensor(prompt, device=dev),
                    S.Spec(("data",), None), mesh)
                sync()
                t0 = time.perf_counter()
                logits, pre = tmodel.forward_prefill(cfg, params, tokens,
                                                     device=dev)
                out = [logits.full_tensor().cpu()]
                sync()
                prefill_s = time.perf_counter() - t0
                full = tmodel.init_caches(cfg, b, rows, device=dev)
                for c, p in zip(full, pre):
                    for key in ("k", "v"):
                        c[key][:, :s] = p[key].full_tensor()
                del pre
                cspec = S.sanitize_specs_np(
                    S.cache_specs_np(cfg, mesh, b, opts), full, mesh)
                caches = [{k: S.distribute_tensor_torch(t, cs[k], mesh)
                           for k, t in c.items()}
                          for c, cs in zip(full, cspec)]
                del full
                placements = [str(p) for p in caches[0]["k"].placements]
                for i, tok in enumerate(feed):
                    token = S.distribute_tensor_torch(
                        torch.as_tensor(tok, device=dev), tspec, mesh)
                    sync()
                    t0 = time.perf_counter()
                    logits, caches = tmodel.forward_decode(
                        cfg, params, caches, token, s + i, device=dev)
                    logits = logits.full_tensor()
                    sync()
                    walls.append(time.perf_counter() - t0)
                    out.append(logits.cpu())
            del caches
            if rank == 0:
                torch.save(out, Path(out_dir) / f"{shard}.pt")
            (Path(out_dir) / f"{shard}_rank{rank}.json").write_text(
                json.dumps(dict(
                    rank=rank, shard=shard, placements=placements,
                    prefill_s=prefill_s, step_s=walls,
                    launches={n: fn.launches for n, fn in counters.items()},
                    device=str(dev),
                    peak_gib=(torch.cuda.max_memory_allocated(dev) / 2**30
                              if dev.type == "cuda" else None))))
    finally:
        dist.destroy_process_group()

def profiled_device_times(prof, range_name):
    """What a serving profile reads of a finished ``torch.profiler.profile``,
    from its raw kineto events: ({kernel name: [device us, count]} over the
    device events, as ``key_averages()`` groups them for
    ``DeviceType.CUDA``, leaving out the ``range_name`` annotation's own
    span; and the device us of the CPU ranges named ``range_name``, their
    ``device_time_total``: the kernels linked to each CPU op inside such a
    range on the same thread, the range included). The profiler's own
    names, filters and times, without the ``FunctionEvent`` it builds for
    every event: ``key_averages()`` took 23.1 s and 42.6 s at qwen3's and
    granite_moe's profiled windows on an H100 80GB HBM3's host, this pass
    2.9 s and 4.6 s, with equal readings (``profile_check.py``)."""
    import bisect
    from collections import defaultdict
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import _filter_name, _rewrite_name
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    rows = {}
    linked = defaultdict(float)  # CPU op's correlation id -> its kernels' us
    ops = []        # (correlation id, thread, start, end) of the CPU ops
    ranges = {}     # thread -> [(start, end)] of the ``range_name`` ranges
    for e in res.events():
        name = e.name()
        if _filter_name(name) or getattr(e, "is_hidden_event", bool)():
            continue
        is_async = e.is_async() or e.start_thread_id() != e.end_thread_id()
        kind = e.device_type()
        if kind == DeviceType.CUDA and name != range_name:
            us = (e.end_ns() - t0) / 1000 - (e.start_ns() - t0) / 1000
            row = rows.setdefault(_rewrite_name(name=name, with_wildcard=True),
                                  [0.0, 0])
            row[0] += 0.0 if is_async else us
            row[1] += 1
            if e.linked_correlation_id() > 0:
                linked[e.linked_correlation_id()] += us
        elif kind == DeviceType.CPU and not is_async:
            span = (e.start_ns(), e.end_ns())
            if name == range_name:
                ranges.setdefault(e.start_thread_id(), []).append(span)
            if e.linked_correlation_id() == 0:
                ops.append((e.correlation_id(), e.start_thread_id(), *span))
    for spans in ranges.values():
        spans.sort()
    range_us = 0.0
    for corr, thread, start, end in ops:
        spans = ranges.get(thread, ())
        i = bisect.bisect_right(spans, (start, float("inf"))) - 1
        if i >= 0 and start < spans[i][1] and end <= spans[i][1]:
            range_us += linked.get(corr, 0.0)
    return rows, range_us


def reset_counts(counters):
    """Every wrapper's launch counts, its bodies' too, set to 0."""
    for fn in counters.values():
        fn.launches = 0
        for attr in BODY_COUNTS + DECODE_BODY_COUNTS + VARIANT_COUNTS:
            if hasattr(fn, attr):
                setattr(fn, attr, 0)


def wrappers():
    """Each kernel's wrapper, which counts its launches in ``.launches``."""
    from repro_torch.kernels.decode_attention import kernel as decode
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.psdsf_fill import kernel as fill
    from repro_torch.kernels.psdsf_fill_bucketed import kernel as bucketed
    from repro_torch.kernels.psdsf_vds import kernel as vds
    from repro_torch.kernels.ssd_scan import kernel as ssd
    return {"psdsf_fill": fill.fill_event_levels,
            "psdsf_fill_bucketed": bucketed.fill_event_levels_bucketed,
            "psdsf_vds": vds.vds_argmin,
            "flash_attention": flash.flash_attention,
            "decode_attention": decode.decode_attention,
            "ssd_scan": ssd.ssd_scan}


class Smoke:
    """Runs the phases, records failures, and collects the kernel rows."""

    def __init__(self, rehearse: bool):
        import torch
        self.torch = torch
        self.rehearse = rehearse
        self.device = torch.device("cpu" if rehearse else "cuda")
        # float32 comparisons in full float32, stated, not left to defaults
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
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

    def time_ms(self, fn, iters, graph=False):
        """Mean milliseconds of ``fn`` over ``iters`` warm calls: CUDA
        events around back-to-back calls, or (``graph``) around a replay of
        one CUDA graph of the ``iters`` calls, which leaves out the host's
        time to launch them (a kernel shorter than its Python call is
        otherwise timed at the host's pace); host clock in a rehearsal."""
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
        if graph:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(iters):
                    fn()
            g.replay()
            torch.cuda.synchronize()
            start.record()
            g.replay()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / iters
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def timed(self, fn, iters):
        """(graph-replay ms, back-to-back ms) of ``fn``: see ``time_ms``."""
        return (self.time_ms(fn, iters, graph=True),
                self.time_ms(fn, iters))

    def interleaved(self, kernel_fn, library_fn, iters):
        """Kernel and library call timed in turns, kernel, library, library,
        kernel (graph replays): the readings of each, in that order."""
        k1 = self.time_ms(kernel_fn, iters, graph=True)
        l1 = self.time_ms(library_fn, iters, graph=True)
        l2 = self.time_ms(library_fn, iters, graph=True)
        k2 = self.time_ms(kernel_fn, iters, graph=True)
        return [k1, k2], [l1, l2]

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
        logs = _build.build(list(KERNELS))
        print(f"built {sorted(logs) or 'nothing (cached)'} in "
              f"{time.perf_counter() - t0:.1f} s")
        for name, log in logs.items():
            lines = log.splitlines()
            entries = sum("Compiling entry function" in ln for ln in lines)
            if entries > 16:
                # one line per source of many instances (the bucketed fill's
                # dtype x R x slots), and every one that spills
                regs = [int(ln.split("Used ")[1].split()[0]) for ln in lines
                        if "registers" in ln and "Used " in ln]
                print(f"  {name}: {entries} kernels, {min(regs)}-"
                      f"{max(regs)} registers a thread")
            entry = ""
            for line in lines:
                if "Compiling entry function" in line:
                    entry = line.split("'")[1] if "'" in line else line
                    if entries <= 16:
                        print(f"  {name}: {entry[:100]}")
                elif entries <= 16 and ("registers" in line
                                        or "spill" in line):
                    print(f"  {name}: {line.strip()}")
                elif "spill" in line and " 0 bytes spill stores" not in line:
                    print(f"  {name}: {entry[-60:]}: {line.strip()}")

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
            # every pass over the entries that can move a usage: an entry
            # of rate 0 adds exactly 0 to every sum
            nnz = int((args[1] > 0).sum())
            flops = (steps + 3) * nnz * (2 * r + 3)
            bound_ms, bound_by = self.bound(nbytes, flops, label)
            ms, eager_ms = self.timed(lambda: kernel.fill_event_levels(
                *args, steps=steps), 10)
            plain_ms = self.time_ms(lambda: ref.fill_event_levels(
                *args, steps=steps), 3)
            print(f"  {label} {n}x{k} R={r} steps={steps}: kernel {ms:.4f} ms"
                  f" ({eager_ms:.4f} ms back to back), plain {plain_ms:.3f} "
                  f"ms, bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, "
                  f"{flops / 1e9:.3f} GFLOP over the {nnz} entries of rate "
                  f"> 0: bound by {bound_by})")
            self.rows[("psdsf_fill", label)] = dict(
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                shape=f"{n}x{k}x{r}")

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
            ms, eager_ms = self.timed(
                lambda: kernel.fill_event_levels_bucketed(*args, steps=steps),
                50)
            plain_ms = self.time_ms(lambda: ref.fill_event_levels_bucketed(
                *args, steps=steps), 5)
            how = kernel.plan(bmax, r, dtype, steps)
            print(f"  {label} buckets {k}x{bmax} R={r} steps={steps}: kernel "
                  f"{ms:.4f} ms ({eager_ms:.4f} ms back to back), plain "
                  f"{plain_ms:.3f} ms, bound "
                  f"{bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e6:.1f} MFLOP: bound by {bound_by}); plan: "
                  f"{how['threads']} threads, {how['slots']} slots a thread, "
                  f"{how['passes']} passes an event ({how['path']})")
            self.rows[("psdsf_fill_bucketed", label)] = dict(
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err,
                shape=f"{k}x{bmax}x{r}", plan=how)
            self.bucketed_plans(label, args, want, got, steps)

    def bucketed_plans(self, label, args, want, first, steps):
        """The bucketed kernel's three paths on one event (registers, shared
        memory, streamed), forced through the wrapper's thresholds: each
        must give the default plan's bits and hold the plain version, and
        each is timed (graph replays)."""
        if self.rehearse:
            print("  rehearsal: no card, no path timings")
            return
        torch = self.torch
        from repro_torch.kernels.psdsf_fill_bucketed import kernel
        paths = {"registers": (kernel.REG_SLOTS, kernel.SMEM_STAGE_MAX),
                 "shared": ((), kernel.SMEM_STAGE_MAX), "streamed": ((), 0)}
        table = {}
        for path, (reg, smem) in paths.items():
            with mock.patch.object(kernel, "REG_SLOTS", reg), \
                    mock.patch.object(kernel, "SMEM_STAGE_MAX", smem):
                def run():
                    return kernel.fill_event_levels_bucketed(*args,
                                                             steps=steps)
                got = run()
                self.sync()
                self.check(all(torch.equal(a, b) for a, b in zip(got, first)),
                           f"bucketed {label} {path} differs from the "
                           f"default plan")
                err = max(float((a - b).abs().max())
                          for a, b in zip(got, want))
                ms = self.time_ms(run, 20, graph=True)
            table[path] = ms
            print(f"    {label} {path}: {ms:.4f} ms, max|kernel-plain|="
                  f"{err:.3e}, bits equal to the default plan's")
        self.paths.setdefault("bucketed_plans", {})[label] = table

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
        ms, eager_ms = self.timed(lambda: kernel.vds_argmin(xo, g), 50)
        plain_ms = self.time_ms(lambda: ref.vds_argmin(xo, g), 10)
        library_ms = self.time_ms(lambda: torch.min(snorm, dim=0), 50,
                                  graph=True)
        nbytes = n * k * 4 + n * 4 + k * 8
        bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                       2 * n * k / PEAK_FLOPS["float32"]) * 1e3
        print(f"  vds {n}x{k}: kernel {ms:.4f} ms ({eager_ms:.4f} ms back "
              f"to back), plain {plain_ms:.4f} ms, "
              f"torch.min(snorm, dim=0) {library_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB)")
        self.rows[("psdsf_vds", "float32")] = dict(
            ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes", max_abs_err=err, library_ms=library_ms,
            shape=f"{n}x{k}")
        if self.rehearse:
            print("  rehearsal: no card, no grid")
            return
        big = torch.as_tensor(self.big_gamma, dtype=torch.float32,
                              device=self.device).contiguous()
        xo_big = torch.as_tensor(rng.uniform(0.0, 10.0, big.shape[0]),
                                 dtype=torch.float32, device=self.device)
        sms = kernel._sm_count(self.device)
        for gx, xg in ((g, xo), (big, xo_big)):
            n_, k_ = gx.shape
            shape = f"{n_}x{k_}"
            self.compare_vds(kernel.vds_argmin(xg, gx), ref.vds_argmin(xg, gx),
                             f"{shape} gamma")
            t = self.time_ms(lambda: kernel.vds_argmin(xg, gx), 50,
                             graph=True)
            # the merge alone, on the slabs' partials of the plain version
            grid = kernel.grid(n_, k_, sms)
            rows = grid["rows"]
            starts = range(0, n_, rows)
            parts = [ref.vds_argmin(xg[r0:r0 + rows], gx[r0:r0 + rows])
                     for r0 in starts]
            pmin = torch.stack([p[0] for p in parts]).contiguous()
            parg = torch.stack([p[1] + r0 for p, r0 in zip(parts, starts)])
            parg = parg.to(torch.int32).contiguous()
            self.compare_vds(kernel.merge_slabs(pmin, parg),
                             ref.vds_argmin(xg, gx), f"{shape} merge alone")
            merge_ms = self.time_ms(lambda: kernel.merge_slabs(pmin, parg),
                                    50, graph=True)
            print(f"    {shape}: grid {grid['tiles']} column tiles x "
                  f"{grid['slabs']} slabs of {grid['rows']} rows on {sms} "
                  f"SMs: {t:.4f} ms, the merge kernel alone {merge_ms:.4f} ms")
            self.paths.setdefault("vds_grid", {})[shape] = dict(
                grid, ms=t, merge_ms=merge_ms)
            if gx is g:
                self.rows[("psdsf_vds", "float32")].update(
                    grid=grid, merge_ms=merge_ms)

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
        counters = wrappers()
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
        reset_counts(counters)
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

    # -- the allocator's consumers: churn loop, tick layer, batched resolve -
    def churn_stream(self, layout, plain=False):
        """The churn phase's stream on the pin: ``ChurnSimulator`` (Jacobi
        rounds, bisect fill, 32 rounds at tol 1e-6, float32) stepped to the
        t = 0 equilibrium, then through ``poisson_churn_events`` (seed 2)
        one batch of simultaneous events at a time, each step timed with
        its telemetry. ``plain`` drives it with the kernels' plain versions
        (no launch). Returns (simulator, records, step walls in s)."""
        import itertools
        from repro_torch.sched import ChurnSimulator, poisson_churn_events
        pin = self.pin
        horizon, rate = (4, 3.0) if self.rehearse else (12, 40.0)
        events = poisson_churn_events(
            pin.num_users, pin.num_servers, horizon=horizon,
            arrival_rate=rate, departure_rate=rate, degrade_rate=0.25,
            seed=2)
        batches = [(0.0, [])] + [(t, list(evs)) for t, evs in
                                 itertools.groupby(events, lambda e: e.time)]
        records, walls = [], []
        with (self.plain_versions() if plain else contextlib.nullcontext()):
            sim = ChurnSimulator(pin, layout=layout, fill="bisect",
                                 round="jacobi", max_rounds=32, tol=1e-6,
                                 device=self.device)
            for t, evs in batches:
                self.sync()
                t0 = time.perf_counter()
                records.append(sim.step(evs, t))
                self.sync()
                walls.append(time.perf_counter() - t0)
        return sim, records, walls

    @staticmethod
    def plain_versions():
        """Every allocator kernel's wrapper swapped for its plain version
        where the ops modules call it, so a path runs with no launch."""
        from repro_torch.kernels.psdsf_fill import ops as fill_ops
        from repro_torch.kernels.psdsf_fill import ref as fill_ref
        from repro_torch.kernels.psdsf_fill_bucketed import ops as b_ops
        from repro_torch.kernels.psdsf_fill_bucketed import ref as b_ref
        from repro_torch.kernels.psdsf_vds import ops as vds_ops
        from repro_torch.kernels.psdsf_vds import ref as vds_ref
        stack = contextlib.ExitStack()
        for module, name, plain in (
                (fill_ops, "fill_event_levels", fill_ref.fill_event_levels),
                (b_ops, "fill_event_levels_bucketed",
                 b_ref.fill_event_levels_bucketed),
                (vds_ops, "vds_argmin", vds_ref.vds_argmin)):
            stack.enter_context(mock.patch.object(module, name, plain))
        return stack

    def check_launches(self, launches, want, what):
        """On the card: each kernel of ``want`` launched exactly that many
        times on the path, every other kernel never (a rehearsal launches
        nothing)."""
        if self.rehearse:
            return
        for name, count in launches.items():
            self.check(count == want.get(name, 0),
                       f"{name} launched {count} times on the {what}, "
                       f"expected {want.get(name, 0)}")

    def compare_streams(self, got, want, what):
        """Two runs of the churn stream: equal rounds and bottleneck servers
        record by record, final x within PATH_F32_REL x max(1, max|x|),
        every record's min_vds within PATH_F32_REL relative."""
        import numpy as np
        (sim_a, rec_a, _), (sim_b, rec_b, _) = got, want
        self.check([r.rounds for r in rec_a] == [r.rounds for r in rec_b],
                   f"{what}: round counts differ")
        self.check([r.bottleneck_server for r in rec_a]
                   == [r.bottleneck_server for r in rec_b],
                   f"{what}: bottleneck servers differ")
        scale = max(1.0, float(np.abs(sim_b.x).max()))
        dx = float(np.abs(sim_a.x - sim_b.x).max())
        vds = max(abs(a.min_vds - b.min_vds) / abs(b.min_vds)
                  for a, b in zip(rec_a, rec_b))
        print(f"  {what}: rounds and bottleneck servers equal over "
              f"{len(rec_a)} records, max|dx|={dx:.3e} (bound "
              f"{PATH_F32_REL * scale:.1e}), min_vds rel {vds:.2e} (bound "
              f"{PATH_F32_REL:.0e})")
        self.check(dx <= PATH_F32_REL * scale and vds <= PATH_F32_REL,
                   f"{what}: x or min_vds out of bounds")

    def churn_path(self):
        """Drive the churn loop at the pin with every count set to 0 just
        before it and read just after; check the launches against the
        rounds, print the ticks, then hold the run against the same stream
        driven with the plain versions and against a dense-layout run."""
        import numpy as np
        counters = wrappers()
        reset_counts(counters)
        run = self.churn_stream("auto")
        launches = {name: fn.launches for name, fn in counters.items()}
        sim, records, walls = run
        rounds = [r.rounds for r in records]
        print(f"  layout={sim.layout}, bucket_max={records[0].bucket_max}, "
              f"{len(records)} records (t = 0 and {len(records) - 1} event "
              f"ticks), rounds {rounds}, launches {launches}")
        self.check(sim.layout == "bucketed", "churn layout='auto' resolved "
                                             f"to {sim.layout}")
        # R = 4 (RDM): five saturation events, one launch each, a round
        self.check_launches(launches, {"psdsf_fill_bucketed": 5 * sum(rounds),
                                       "psdsf_vds": len(records)},
                            "churn path")
        ticks = records[1:]
        solve = np.array([r.solve_ms for r in ticks])
        print(f"  event ticks: solve_ms median {np.median(solve):.1f} max "
              f"{solve.max():.1f}; warm rounds median "
              f"{np.median([r.rounds for r in ticks]):.0f} max "
              f"{max(r.rounds for r in ticks)}; events a tick median "
              f"{np.median([r.n_events for r in ticks]):.0f}; tick wall with "
              f"telemetry median {np.median(walls[1:]) * 1e3:.1f} ms max "
              f"{max(walls[1:]) * 1e3:.1f} ms; t = 0 solve "
              f"{records[0].solve_ms:.1f} ms ({records[0].rounds} rounds)")
        x = sim.x
        self.check(bool(np.isfinite(x).all()) and float(x.min()) >= 0.0,
                   "churn x not finite or negative")
        caps = sim.allocation().problem.capacities      # degrade-scaled
        over = float((np.einsum("nk,nr->kr", x, self.pin.demands)
                      - caps).max())
        print(f"  final allocation: max(usage - capacity) = {over:.3e}")
        # float32 usage sums over a server's ~700 users
        self.check(over <= PATH_F32_REL * caps.max(),
                   "churn allocation infeasible")
        self.check(all(np.isfinite(r.min_vds) for r in records),
                   "churn min_vds not finite")
        self.paths["churn"] = dict(
            launches=launches, records=len(records), rounds=rounds,
            events=[r.n_events for r in records],
            solve_ms=[r.solve_ms for r in records],
            tick_wall_ms=[w * 1e3 for w in walls],
            min_vds=[r.min_vds for r in records],
            bottleneck=[r.bottleneck_server for r in records])
        self.compare_streams(run, self.churn_stream("auto", plain=True),
                             "kernel-driven vs plain-driven churn")
        reset_counts(counters)
        dense = self.churn_stream("dense")
        dense_launches = {name: fn.launches for name, fn in counters.items()}
        d_rounds = [r.rounds for r in dense[1]]
        print(f"  dense layout: launches {dense_launches}, tick wall median "
              f"{np.median(dense[2][1:]) * 1e3:.1f} ms")
        self.check_launches(dense_launches, {"psdsf_fill": 5 * sum(d_rounds),
                                             "psdsf_vds": len(dense[1])},
                            "dense churn path")
        self.paths["churn_dense"] = dict(
            launches=dense_launches, rounds=d_rounds,
            tick_wall_ms=[w * 1e3 for w in dense[2]])
        self.compare_streams(dense, run, "dense vs bucketed churn")
        self.profile_churn_tick(sim)      # after the comparisons: it steps

    def profile_churn_tick(self, sim):
        """One more churn tick of ``sim`` (the events of the stream's seed
        3, first tick) under torch.profiler: wall, device busy, each
        allocator kernel's share, idle share, and the top host ops."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.sched import poisson_churn_events
        pin = self.pin
        rate = 3.0 if self.rehearse else 40.0
        events = poisson_churn_events(pin.num_users, pin.num_servers,
                                      horizon=1, arrival_rate=rate,
                                      departure_rate=rate, degrade_rate=1.0,
                                      seed=3)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):        # the first start is slow
            pass
        self.sync()
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            rec = sim.step(events, 100.0)
            self.sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(float(e.self_device_time_total), e.key, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy_ms = sum(r[0] for r in rows) / 1e3
        if busy_ms <= 0:
            print("  profiled churn tick: the profiler saw no device time: "
                  "not measured")
            return
        share = {name: sum(r[0] for r in rows if key in r[1]) / 1e3
                 for name, key in (("psdsf_fill_bucketed",
                                    "fill_bucketed_kernel"),
                                   ("psdsf_vds", "vds_"))}
        print(f"  profiled churn tick ({len(events)} events, {rec.rounds} "
              f"rounds): wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
              f"({', '.join(f'{k} {v:.2f} ms' for k, v in share.items())}), "
              f"idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}")
        for us, key, count in sorted(rows, reverse=True)[:6]:
            print(f"    {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
        host = sorted(((float(e.self_cpu_time_total), e.key, e.count)
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU), reverse=True)
        for us, key, count in host[:6]:
            print(f"    host {us / 1e3:9.3f} ms {count:6d}x  {key[:80]}")
        self.paths["churn"]["profiled_tick"] = dict(
            wall_ms=wall_ms, busy_ms=busy_ms, kernels_ms=share,
            idle=max(0.0, 1 - busy_ms / wall_ms), rounds=rec.rounds)

    def tick_path(self):
        """Drive ``DistributedPSDSF`` (float32, bisect fill, layout auto) at
        the pin: one full tick, a departure and a tick over that user's
        servers, then ``min_vds`` (one ``psdsf_vds`` launch); hold x and the
        telemetry to the same calls on the CPU."""
        import numpy as np
        from repro_torch.core.dynamic import DistributedPSDSF
        pin = self.pin
        user = 0
        servers = np.nonzero(self.pin_gamma[user] > 0)[0]

        def drive(device):
            sim = DistributedPSDSF(pin, engine="torch", precision="fast",
                                   fill="bisect", layout="auto",
                                   device=device)
            walls = []
            for call in (lambda: sim.tick(),
                         lambda: sim.set_active(user, False),
                         lambda: sim.tick(servers=servers)):
                t0 = time.perf_counter()
                call()
                walls.append(time.perf_counter() - t0)
            return sim, sim.min_vds(), walls

        counters = wrappers()
        reset_counts(counters)
        sim, (mn, arg), walls = drive(self.device)
        launches = {name: fn.launches for name, fn in counters.items()}
        print(f"  layout={sim.layout}, bucket_max={sim.bucket_max}: full "
              f"tick {walls[0]:.3f} s, tick over user {user}'s "
              f"{len(servers)} servers {walls[2]:.3f} s, launches {launches}")
        self.check_launches(launches, {"psdsf_vds": 1}, "tick path")
        self.check(not sim.x[user].any(), "the departed user kept tasks")
        cpu, (mn_c, arg_c), walls_c = drive("cpu")
        scale = max(1.0, float(np.abs(cpu.x).max()))
        dx = float(np.abs(sim.x - cpu.x).max())
        rel = float((np.abs(mn - mn_c) / np.abs(mn_c)).max())
        # an argmin may differ only between users whose normalized VDS lie
        # within the bound: the card's pick, valued on the CPU's x, must
        # attain the CPU's minimum to PATH_F32_REL
        cols = np.arange(pin.num_servers)
        xo = cpu.x.sum(axis=1) / pin.weights
        picked = xo[arg] / self.pin_gamma[arg, cols]
        moved = int((arg != arg_c).sum())
        ties_ok = bool(np.all(picked <= mn_c * (1 + PATH_F32_REL))
                       and cpu.active[arg].all())
        print(f"  card vs CPU: max|dx|={dx:.3e} (bound "
              f"{PATH_F32_REL * scale:.1e}), min_vds rel {rel:.2e}, argmin "
              f"differs on {moved} of {len(arg)} servers, each a tie within "
              f"the bound: {ties_ok}; CPU full tick {walls_c[0]:.3f} s")
        self.check(dx <= PATH_F32_REL * scale and rel <= PATH_F32_REL
                   and ties_ok, "tick path on the card differs from the CPU")
        self.paths["tick"] = dict(launches=launches, full_tick_s=walls[0],
                                  partial_tick_s=walls[2],
                                  cpu_full_tick_s=walls_c[0])

    def batched_path(self):
        """``psdsf_resolve_batched`` over four scenarios of the pin, each
        with one server degraded to 0.5, from the float64 fixed point of
        the main path (bucketed, Jacobi, bisect), counts set to 0 just
        before and read just after; each scenario is held to its own
        unbatched warm-started solve, the same two phases through the
        bucketed core alone."""
        import numpy as np
        torch = self.torch
        from repro_torch.core.batched import (batch_problems,
                                              psdsf_resolve_batched)
        from repro_torch.core.psdsf_torch import _solve_core_bucketed_torch
        from repro_torch.core.types import AllocationProblem
        pin, lay = self.pin, self.pin_layout
        k = pin.num_servers
        degraded = [j * k // 4 for j in range(4)]
        probs, rows = [], []
        for s in degraded:
            caps = pin.capacities.copy()
            caps[s] *= 0.5
            probs.append(AllocationProblem(pin.demands, caps, pin.weights,
                                           pin.eligibility))
            rows.append(np.unique(np.concatenate(
                [[s], lay.servers_of(lay.bucket_users(s))])).astype(np.int32))
        width = max(len(r) for r in rows)
        srv = np.stack([np.pad(r, (0, width - len(r)), mode="edge")
                        for r in rows])
        bat = batch_problems(probs, dtype=np.float64, device=self.device)
        arrays = [bat[key] for key in ("demands", "capacities", "weights",
                                       "gamma")]
        x0 = np.stack([self.x_dense] * len(probs))
        idx = np.stack([lay.indices] * len(probs))
        mask = np.stack([lay.mask] * len(probs))
        kw = dict(max_rounds=16, tol=1e-6, fill="bisect", round="jacobi",
                  layout="bucketed")
        counters = wrappers()
        reset_counts(counters)
        self.sync()
        t0 = time.perf_counter()
        x, r_restr, r_full, resid = psdsf_resolve_batched(
            *arrays, x0, srv, buckets=(idx, mask), device=self.device, **kw)
        self.sync()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        total = int(r_restr.sum() + r_full.sum())
        print(f"  B={len(probs)} scenarios (servers {degraded} at 0.5; "
              f"{srv.shape[1]} servers a restricted sweep): {wall:.3f} s, "
              f"restricted rounds {r_restr.tolist()}, full rounds "
              f"{r_full.tolist()}, residual "
              f"{[f'{float(v):.2e}' for v in resid]}, launches {launches}")
        self.check_launches(launches, {"psdsf_fill_bucketed": 5 * total},
                            "batched re-solve")
        idx_t = torch.as_tensor(lay.indices, device=self.device)
        mask_t = torch.as_tensor(lay.mask, device=self.device)
        worst = 0.0
        for j, row in enumerate(rows):
            d, c, w, g = (a[j] for a in arrays)
            x_init = torch.as_tensor(self.x_dense, device=self.device)
            core = dict(fill="bisect", round_mode="jacobi")
            out1 = _solve_core_bucketed_torch(
                d, c, w, g, x_init, idx_t, mask_t, "rdm", 16, 1e-6,
                servers=row, alpha0=0.3, **core)
            out2 = _solve_core_bucketed_torch(
                d, c, w, g, out1[0], idx_t, mask_t, "rdm", 16, 1e-6,
                alpha0=0.02, **core)
            diff = float((x[j] - out2[0]).abs().max())
            worst = max(worst, diff)
            self.check(out1[1] == int(r_restr[j]) and out2[1] == int(r_full[j])
                       and diff <= F64_ATOL,
                       f"scenario {j} differs from its unbatched solve")
            self.check(bool(torch.isfinite(x[j]).all())
                       and float(x[j].min()) >= 0.0,
                       f"scenario {j} x not finite or negative")
        print(f"  each scenario vs its unbatched warm-started solve: round "
              f"counts equal, max|dx|={worst:.3e} (bound {F64_ATOL:.0e})")
        self.paths["batched"] = dict(
            launches=launches, wall_s=wall, restricted=r_restr.tolist(),
            full=r_full.tolist(), servers_a_sweep=int(srv.shape[1]))

    # -- headroom placement and the baselines --------------------------------
    def profile_window(self, label, fn, keys, host_ops=True):
        """``fn`` under torch.profiler: wall, device busy, the time of each
        kernel of ``keys`` (name -> substring of its CUDA symbol) and the
        idle share; ``None`` when the profiler saw no device time.
        ``host_ops=False`` traces the device alone (a window of ~10^5
        small launches otherwise costs minutes of host-side recording)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        acts = ([ProfilerActivity.CPU]
                if host_ops or self.device.type != "cuda" else [])
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):        # the first start is slow
            pass
        self.sync()
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            fn()
            self.sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(float(e.self_device_time_total), e.key, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy_ms = sum(r[0] for r in rows) / 1e3
        if busy_ms <= 0:
            print(f"  {label}: the profiler saw no device time: not measured")
            return None
        share = {name: sum(r[0] for r in rows if key in r[1]) / 1e3
                 for name, key in keys.items()}
        idle = max(0.0, 1 - busy_ms / wall_ms)
        print(f"  {label}, profiled: wall {wall_ms:.1f} ms, device busy "
              f"{busy_ms:.1f} ms ("
              + ", ".join(f"{k} {v:.2f} ms" for k, v in share.items())
              + f"), idle share {idle:.3f}")
        for us, key, count in sorted(rows, reverse=True)[:5]:
            print(f"    {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
        return dict(wall_ms=wall_ms, busy_ms=busy_ms, kernels_ms=share,
                    idle=idle)

    def check_feasible(self, prob, x, label, rel=1e-9):
        """x finite, non-negative and within the capacities to ``rel`` x
        the largest capacity."""
        import numpy as np
        self.check(x.shape == (prob.num_users, prob.num_servers)
                   and bool(np.isfinite(x).all()) and float(x.min()) >= 0.0,
                   f"{label}: x not finite, negative or misshapen")
        over = float((np.einsum("nk,nr->kr", x, prob.demands)
                      - prob.capacities).max())
        self.check(over <= rel * prob.capacities.max(),
                   f"{label}: allocation infeasible ({over:.3e})")
        return over

    def headroom_path(self):
        """``engine.solve(pin, "psdsf-rdm", placement="headroom")`` in
        float64 on the dense layout (Jacobi rounds of the bisect fill, 32
        at tol=0 for the level solve and each refill), counts set to 0 just
        before and read just after: the level solve, then up to three
        repack passes, each followed by a warm dense refill through
        ``psdsf_fill``. The wall is split into the three by timing the
        module functions the solve calls; the fill launches must be 5 x
        every refill's and the level solve's rounds. Held against the same
        solve with the plain versions patched in (1e-9, equal rounds)."""
        import numpy as np
        from repro_torch.core import engine, placement_torch, psdsf_torch
        pin = self.pin
        kw = dict(placement="headroom", fill="bisect", round="jacobi",
                  layout="dense", max_rounds=32, tol=0.0)

        def timed_calls(plain=False):
            log = {"level": [], "repack": [], "refill": []}

            def wrap(what, fn):
                def run(*a, **k):
                    self.sync()
                    t0 = time.perf_counter()
                    out = fn(*a, **k)
                    self.sync()
                    log[what].append((time.perf_counter() - t0,
                                      out[1] if isinstance(out, tuple)
                                      else None))
                    return out
                return run
            stack = self.plain_versions() if plain else contextlib.ExitStack()
            for module, name, what in (
                    (psdsf_torch, "_solve_core_torch", "level"),
                    (placement_torch, "_repack_core_torch", "repack"),
                    (placement_torch, "_solve_core_torch", "refill")):
                stack.enter_context(mock.patch.object(
                    module, name, wrap(what, getattr(module, name))))
            with stack:
                self.sync()
                t0 = time.perf_counter()
                alloc, info = engine.solve(pin, "psdsf-rdm",
                                           device=self.device, **kw)
                self.sync()
            return alloc, info, time.perf_counter() - t0, log

        counters = wrappers()
        reset_counts(counters)
        alloc, info, wall, log = timed_calls()
        launches = {name: fn.launches for name, fn in counters.items()}
        level_rounds = log["level"][0][1]
        refill_rounds = [r for _, r in log["refill"]]
        split = {what: sum(t for t, _ in calls) for what, calls in
                 log.items()}
        print(f"  f64 {pin.num_users}x{pin.num_servers} headroom "
              f"engine.solve: {wall:.3f} s wall = level solve "
              f"{split['level']:.3f} s ({level_rounds} rounds) + "
              f"{len(log['repack'])} repack passes {split['repack']:.3f} s "
              f"({', '.join(f'{t:.3f}' for t, _ in log['repack'])}) + "
              f"refills {split['refill']:.3f} s (rounds {refill_rounds}); "
              f"kept rounds={info.rounds}, residual={info.residual:.3e}, "
              f"stranded={info.stranded_frac:.5f}, launches {launches}")
        self.check_launches(launches, {"psdsf_fill": 5 * (
            level_rounds + sum(refill_rounds))}, "headroom path")
        over = self.check_feasible(pin, alloc.x, "headroom")
        plain, p_info, p_wall, p_log = timed_calls(plain=True)
        diff = float(np.abs(plain.x - alloc.x).max())
        print(f"  kernel-driven vs plain-driven headroom solve: max|dx|="
              f"{diff:.3e}, rounds {info.rounds} / {p_info.rounds}, refill "
              f"rounds {refill_rounds} / {[r for _, r in p_log['refill']]};"
              f" plain-driven wall {p_wall:.3f} s; max(usage - capacity) "
              f"{over:.3e}")
        self.check(diff <= F64_ATOL and info.rounds == p_info.rounds
                   and [r for _, r in p_log["refill"]] == refill_rounds,
                   "kernel-driven and plain-driven headroom solves disagree")
        level_x = getattr(self, "x_dense", None)
        if level_x is not None:
            print(f"  headroom vs the main path's level solve: max|dx|="
                  f"{float(np.abs(alloc.x - level_x).max()):.3e}, per-user "
                  f"totals moved by up to "
                  f"{float(np.abs(alloc.tasks_per_user - level_x.sum(axis=1)).max()):.3e}"
                  f" (the repack keeps them; the refills re-solve)")
        # one pass and its refill, traced on the device alone, on a 5,000 x
        # 256 cut of the generator: the pin's pass is ~250,000 launches
        from repro_torch.core.gamma import gamma_matrix
        from repro_torch.core.instances import sparse_cell_instance
        torch = self.torch
        cut, _ = sparse_cell_instance(
            num_users=100 if self.rehearse else 5000,
            num_servers=16 if self.rehearse else 256,
            cells=4 if self.rehearse else 16)
        level, _ = engine.solve(cut, "psdsf-rdm", device=self.device,
                                fill="bisect", round="jacobi",
                                layout="dense", max_rounds=32, tol=0.0)
        arrays = [torch.as_tensor(a, device=self.device) for a in (
            cut.demands, cut.capacities, cut.weights, gamma_matrix(cut),
            level.x)]
        resid = torch.zeros((), dtype=torch.float64, device=self.device)
        prof = self.profile_window(
            f"one repack pass and its refill on a {cut.num_users}x"
            f"{cut.num_servers} cut (device trace only)",
            lambda: placement_torch._repack_refill_core_torch(
                *arrays, 32, resid, "rdm", 32, 0.0, passes=1,
                fill="bisect", round_mode="jacobi"),
            {"psdsf_fill": "fill_event_kernel"}, host_ops=False)
        self.paths["headroom"] = dict(
            launches=launches, wall_s=wall,
            split_s=split, level_rounds=level_rounds,
            refill_rounds=refill_rounds, kept_rounds=info.rounds,
            residual=info.residual, stranded=info.stranded_frac,
            plain_wall_s=p_wall, profiled_pass=prof)

    def baseline_path(self):
        """``engine.solve`` for tsf, cdrf and cdrfh at level placement
        (float64, Jacobi rounds of the bisect fill, 32 at tol=0) on the
        pin, on the dense layout and on the buckets, counts set to 0 just
        before each and read just after (5 x 32 launches of the layout's
        fill kernel); each held against the same solve with the plain
        versions patched in (1e-9, equal rounds). Then the routed
        headroom fill of tsf at the pin (no kernel; held against the CPU
        on a 2,000 x 64 cut of the same generator)."""
        import numpy as np
        from repro_torch.core import engine
        from repro_torch.core.instances import sparse_cell_instance
        pin = self.pin
        counters = wrappers()
        runs = {}
        for layout, kernel in (("dense", "psdsf_fill"),
                               ("bucketed", "psdsf_fill_bucketed")):
            for mech in ("tsf", "cdrf", "cdrfh"):
                kw = dict(fill="bisect", round="jacobi", layout=layout,
                          max_rounds=32, tol=0.0, device=self.device)
                reset_counts(counters)
                self.sync()
                t0 = time.perf_counter()
                alloc, info = engine.solve(pin, mech, **kw)
                self.sync()
                wall = time.perf_counter() - t0
                launches = {name: fn.launches
                            for name, fn in counters.items()}
                self.check_launches(launches, {kernel: 5 * info.rounds},
                                    f"{mech} {layout} path")
                with self.plain_versions():
                    plain, p_info = engine.solve(pin, mech, **kw)
                diff = float(np.abs(plain.x - alloc.x).max())
                over = self.check_feasible(pin, alloc.x, f"{mech} {layout}")
                print(f"  {mech} {layout}: {wall:.3f} s wall, rounds "
                      f"{info.rounds}, residual {info.residual:.3e}, "
                      f"bucket_max {info.bucket_max}, stranded "
                      f"{info.stranded_frac:.5f}, {kernel} launches "
                      f"{launches[kernel]}; vs plain-driven max|dx|="
                      f"{diff:.3e}; max(usage - capacity) {over:.3e}")
                self.check(diff <= F64_ATOL and info.rounds == p_info.rounds
                           and info.layout == layout,
                           f"{mech} {layout}: kernel-driven and "
                           f"plain-driven solves disagree")
                runs[f"{mech}_{layout}"] = dict(
                    launches=launches, wall_s=wall, rounds=info.rounds,
                    residual=info.residual)
        reset_counts(counters)
        self.sync()
        t0 = time.perf_counter()
        routed, r_info = engine.solve(pin, "tsf", placement="headroom",
                                      device=self.device)
        self.sync()
        r_wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        self.check_launches(launches, {}, "routed tsf fill")
        over = self.check_feasible(pin, routed.x, "routed tsf", rel=1e-6)
        print(f"  tsf routed headroom fill: {r_wall:.3f} s wall, "
              f"{r_info.rounds} events (at most "
              f"{pin.num_servers * pin.num_resources + pin.num_users + 1}), "
              f"stranded {r_info.stranded_frac:.5f} (level dense "
              f"{runs['tsf_dense']['residual']:.1e} residual), max(usage - "
              f"capacity) {over:.3e}")
        cut, _ = sparse_cell_instance(
            num_users=200 if self.rehearse else 2000,
            num_servers=16 if self.rehearse else 64, cells=4)
        a_dev, i_dev = engine.solve(cut, "tsf", placement="headroom",
                                    device=self.device)
        a_cpu, i_cpu = engine.solve(cut, "tsf", placement="headroom",
                                    device="cpu")
        diff = float(np.abs(a_dev.x - a_cpu.x).max())
        print(f"  routed fill on a {cut.num_users}x{cut.num_servers} cut: "
              f"card vs CPU max|dx|={diff:.3e}, events {i_dev.rounds} / "
              f"{i_cpu.rounds}")
        self.check(diff <= F64_ATOL and i_dev.rounds == i_cpu.rounds,
                   "routed fill: card and CPU disagree")
        runs["tsf_routed"] = dict(launches=launches, wall_s=r_wall,
                                  events=r_info.rounds)
        prof = self.profile_window(
            "tsf level solve, dense, 32 Jacobi rounds",
            lambda: engine.solve(pin, "tsf", fill="bisect", round="jacobi",
                                 layout="dense", max_rounds=32, tol=0.0,
                                 device=self.device),
            {"psdsf_fill": "fill_event_kernel"})
        self.paths["baselines"] = dict(
            launches={name: sum(r["launches"][name] for r in runs.values())
                      for name in counters},
            runs=runs, profiled_tsf_dense=prof)

    def baseline_churn(self):
        """``ChurnSimulator(pin, "tsf")`` (float32, layout auto -> buckets,
        Jacobi rounds of the bisect fill, 32 at tol 1e-6) over t = 0 and
        the first ticks of the churn phase's stream (seed 2), counts set
        to 0 just before and read just after (bucketed launches 5 x the
        rounds, one VDS launch a record); held against the same stream
        with the plain versions patched in: rounds equal, per-user totals
        and min_vds within PATH_F32_REL, bottleneck servers
        equal or tied within it; then one more tick profiled."""
        import itertools
        import numpy as np
        from repro_torch.sched import ChurnSimulator, poisson_churn_events
        pin = self.pin
        horizon, rate = (3, 3.0) if self.rehearse else (4, 40.0)
        events = poisson_churn_events(
            pin.num_users, pin.num_servers, horizon=horizon,
            arrival_rate=rate, departure_rate=rate, degrade_rate=0.25,
            seed=2)
        batches = [(0.0, [])] + [(t, list(evs)) for t, evs in
                                 itertools.groupby(events, lambda e: e.time)]

        def run(plain=False):
            records, walls = [], []
            with (self.plain_versions() if plain
                  else contextlib.nullcontext()):
                sim = ChurnSimulator(pin, mechanism="tsf",
                                     fill="bisect", round="jacobi",
                                     max_rounds=32, tol=1e-6,
                                     device=self.device)
                for t, evs in batches:
                    self.sync()
                    t0 = time.perf_counter()
                    records.append(sim.step(evs, t))
                    self.sync()
                    walls.append(time.perf_counter() - t0)
            return sim, records, walls

        counters = wrappers()
        reset_counts(counters)
        sim, records, walls = run()
        launches = {name: fn.launches for name, fn in counters.items()}
        rounds = [r.rounds for r in records]
        print(f"  tsf churn: layout={sim.layout}, bucket_max="
              f"{records[0].bucket_max}, {len(records)} records, rounds "
              f"{rounds}, events {[r.n_events for r in records]}, solve_ms "
              f"{[round(r.solve_ms, 1) for r in records]}, tick walls "
              f"{[round(w * 1e3, 1) for w in walls]} ms, launches "
              f"{launches}")
        self.check(sim.layout == "bucketed",
                   f"tsf churn layout='auto' resolved to {sim.layout}")
        self.check_launches(launches, {"psdsf_fill_bucketed": 5 * sum(rounds),
                                       "psdsf_vds": len(records)},
                            "tsf churn path")
        self.check(all(np.isfinite(r.min_vds) for r in records),
                   "tsf churn min_vds not finite")
        caps = sim.allocation().problem.capacities
        over = float((np.einsum("nk,nr->kr", sim.x, pin.demands)
                      - caps).max())
        self.check(bool(np.isfinite(sim.x).all()) and sim.x.min() >= 0.0
                   and over <= PATH_F32_REL * caps.max(),
                   "tsf churn allocation infeasible")
        p_sim, p_records, _ = run(plain=True)
        self.check(rounds == [r.rounds for r in p_records],
                   "tsf churn: round counts differ from the plain-driven run")
        # a baseline's level rate is the same on all of a user's servers,
        # so its fixed point pins the per-user totals (the levels) and not
        # the split across servers: float32 ulps drift along the split
        # (the CPU shows it too: this stream in the port vs the JAX
        # reference, both on the CPU, differs by 1.8e-4 per entry and
        # 2.1e-6 in the totals); the totals are held, the split printed
        tot, p_tot = sim.x.sum(axis=1), p_sim.x.sum(axis=1)
        scale = max(1.0, float(np.abs(p_tot).max()))
        dtot = float(np.abs(tot - p_tot).max())
        dx = float(np.abs(sim.x - p_sim.x).max())
        vds = max(abs(a.min_vds - b.min_vds) / abs(b.min_vds)
                  for a, b in zip(records, p_records))
        moved = sum(a.bottleneck_server != b.bottleneck_server
                    for a, b in zip(records, p_records))
        print(f"  kernel-driven vs plain-driven tsf churn: rounds equal, "
              f"per-user totals max|d|={dtot:.3e} (bound "
              f"{PATH_F32_REL * scale:.1e}), per entry max|dx|={dx:.3e} "
              f"(the split, not held), min_vds rel {vds:.2e}, bottleneck "
              f"servers differ on {moved} records (a tie: the global "
              f"minima agree within {PATH_F32_REL:.0e})")
        self.check(dtot <= PATH_F32_REL * scale and vds <= PATH_F32_REL,
                   "tsf churn: per-user totals or min_vds out of bounds")
        more = poisson_churn_events(pin.num_users, pin.num_servers,
                                    horizon=1, arrival_rate=rate,
                                    departure_rate=rate, degrade_rate=1.0,
                                    seed=3)
        prof = self.profile_window(
            "one more tsf churn tick", lambda: sim.step(more, 100.0),
            {"psdsf_fill_bucketed": "fill_bucketed_kernel",
             "psdsf_vds": "vds_"})
        self.paths["baseline_churn"] = dict(
            launches=launches, rounds=rounds,
            events=[r.n_events for r in records],
            solve_ms=[r.solve_ms for r in records],
            tick_wall_ms=[w * 1e3 for w in walls], max_dx=dx,
            max_dtotal=dtot, bottleneck_moved=moved, profiled_tick=prof)

    # -- the host lexmm router and the scheduler layers -----------------------
    def lexmm_path(self):
        """``placement="lexmm"`` on the cut, through its three entries:
        (a) ``engine.solve`` for tsf, cdrfh and cdrf (host LPs, no kernel),
        each held to the one-shot cold router (per-user totals, 1e-6 x
        max(1, max total); the cold routes run in a process pool while
        the rest of the phase runs) and checked feasible; (b)
        ``ChurnSimulator(cut, "tsf", placement="lexmm")`` over t = 0 and 4
        ticks of a seeded stream, counts set to 0 just before and read
        just after (one ``psdsf_vds`` launch a record, nothing else), held
        against the same stream with the plain versions patched in; (c)
        ``DistributedPSDSF(cut).routed_allocation("tsf")`` across a
        departure, an arrival and no change, with its router modes."""
        import concurrent.futures
        import multiprocessing
        import numpy as np
        import scipy
        from repro_torch.core import engine
        from repro_torch.core.baselines_torch import level_rate_matrix_np
        from repro_torch.core.flowrouter import RouterState
        from repro_torch.core.instances import sparse_cell_instance
        # a cut of the pin's generator: a from-scratch cold route of the
        # full pin does not end within a run's time (PERF.md section 4)
        cut, _ = sparse_cell_instance(
            num_users=200 if self.rehearse else 2000,
            num_servers=16 if self.rehearse else 64)
        lp_path = ("direct HiGHS wrapper"
                   if RouterState(cut, level_rate_matrix_np(cut, "tsf"))
                   ._direct is not None else "public linprog")
        print(f"  cut {cut.num_users}x{cut.num_servers}, density "
              f"{float((cut.eligibility > 0).mean()):.4f}; LP path "
              f"{lp_path} (scipy {scipy.__version__})")
        mechs = ("tsf", "cdrfh", "cdrf")
        counters = wrappers()
        solves = {}
        spawn = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                len(mechs), mp_context=spawn) as pool:
            colds = {m: pool.submit(cold_route_totals, str(ROOT / "src"),
                                    cut.demands, cut.capacities, cut.weights,
                                    cut.eligibility, m) for m in mechs}
            reset_counts(counters)
            for m in mechs:
                self.sync()
                t0 = time.perf_counter()
                alloc, info = engine.solve(cut, m, placement="lexmm",
                                           device=self.device)
                self.sync()
                solves[m] = (alloc, info, time.perf_counter() - t0)
            launches = {name: fn.launches for name, fn in counters.items()}
            self.check_launches(launches, {}, "lexmm solves")
            churn = self.lexmm_churn(cut, counters)
            routed = self.lexmm_routed(cut, solves["tsf"][0].x)
            colds = {m: f.result() for m, f in colds.items()}
        runs = {}
        for m in mechs:
            alloc, info, wall = solves[m]
            tot_c, stages_c, cold_s = colds[m]
            tot = alloc.x.sum(axis=1)
            scale = max(1.0, float(np.abs(tot_c).max()))
            d = float(np.abs(tot - tot_c).max())
            over = self.check_feasible(cut, alloc.x, f"lexmm {m}", rel=1e-6)
            print(f"  {m} lexmm: {wall:.3f} s wall, {info.rounds} stages "
                  f"(cold {stages_c}, {cold_s:.1f} s), stranded "
                  f"{info.stranded_frac:.5f}, vs cold per-user totals "
                  f"max|d|={d:.3e} (bound {1e-6 * scale:.1e}), max(usage - "
                  f"capacity) {over:.3e}")
            self.check(info.placement == "lexmm" and info.converged
                       and d <= 1e-6 * scale and info.rounds == stages_c,
                       f"lexmm {m}: warm router disagrees with the cold one")
            runs[m] = dict(wall_s=wall, stages=info.rounds,
                           cold_s=cold_s, max_dtotal=d,
                           stranded=info.stranded_frac)
        self.paths["lexmm"] = dict(
            launches={name: churn["launches"][name] + launches[name]
                      for name in counters},
            lp_path=lp_path, scipy=scipy.__version__, solves=runs,
            churn=churn, routed=routed)

    def lexmm_churn(self, cut, counters):
        """The lexmm churn stream on the cut: t = 0 and 4 ticks of a
        seeded stream through ``ChurnSimulator(cut, "tsf",
        placement="lexmm")``, once with the kernels (counted) and once
        with the plain versions; returns the run's record of it."""
        import itertools
        import numpy as np
        from repro_torch.core.dynamic import min_vds_guarded
        from repro_torch.sched import ChurnSimulator, poisson_churn_events
        arr, dep = (0.5, 1.0) if self.rehearse else (0.5, 3.0)
        events = poisson_churn_events(cut.num_users, cut.num_servers,
                                      horizon=4, arrival_rate=arr,
                                      departure_rate=dep, degrade_rate=0.25,
                                      seed=2)
        batches = [(0.0, [])] + [(t, list(evs)) for t, evs in
                                 itertools.groupby(events, lambda e: e.time)]

        def run(plain=False):
            records, walls, mins = [], [], []
            with (self.plain_versions() if plain
                  else contextlib.nullcontext()):
                sim = ChurnSimulator(cut, mechanism="tsf", placement="lexmm",
                                     device=self.device)
                for t, evs in batches:
                    self.sync()
                    t0 = time.perf_counter()
                    records.append(sim.step(evs, t))
                    self.sync()
                    walls.append(time.perf_counter() - t0)
                    if plain:      # per-server minima, for the tie check
                        mn, _ = min_vds_guarded(sim.x, cut.weights,
                                                sim._gamma(), sim.active,
                                                device=self.device)
                        mins.append(mn.cpu().numpy())
            return sim, records, walls, mins

        reset_counts(counters)
        sim, records, walls, _ = run()
        launches = {name: fn.launches for name, fn in counters.items()}
        for rec, wall in zip(records, walls):
            print(f"    t={rec.time:.0f}: {rec.n_events} events, "
                  f"{rec.rounds} stages, lp_calls {rec.lp_calls}, warm_hits "
                  f"{rec.warm_hits}, warm_fallbacks {rec.warm_fallbacks}, "
                  f"mode {rec.router_mode}, solve_ms {rec.solve_ms:.1f}, "
                  f"tick wall {wall * 1e3:.1f} ms")
        print(f"  lexmm churn launches {launches}")
        self.check_launches(launches, {"psdsf_vds": len(records)},
                            "lexmm churn")
        p_sim, p_records, _, p_mins = run(plain=True)
        fields = ("rounds", "lp_calls", "warm_hits", "warm_fallbacks",
                  "router_mode")
        self.check(all(getattr(a, f) == getattr(b, f) for a, b in
                       zip(records, p_records) for f in fields),
                   "lexmm churn: router fields differ from the plain run")
        tot, p_tot = sim.x.sum(axis=1), p_sim.x.sum(axis=1)
        scale = max(1.0, float(np.abs(p_tot).max()))
        dtot = float(np.abs(tot - p_tot).max())
        vds = max(abs(a.min_vds - b.min_vds) / abs(b.min_vds)
                  for a, b in zip(records, p_records))
        moved = [j for j, (a, b) in enumerate(zip(records, p_records))
                 if a.bottleneck_server != b.bottleneck_server]
        # P7: the card's pick must attain the plain run's minimum
        ties_ok = all(p_mins[j][records[j].bottleneck_server]
                      <= p_records[j].min_vds * (1 + PATH_F32_REL)
                      for j in moved)
        print(f"  kernel-driven vs plain-driven lexmm churn: router fields "
              f"equal, per-user totals max|d|={dtot:.3e} (bound "
              f"{PATH_F32_REL * scale:.1e}), min_vds rel {vds:.2e}, "
              f"bottleneck servers differ on {len(moved)} records, each a "
              f"tie within the bound: {ties_ok}")
        self.check(dtot <= PATH_F32_REL * scale and vds <= PATH_F32_REL
                   and ties_ok, "lexmm churn: out of bounds")
        return dict(launches=launches,
                    stages=[r.rounds for r in records],
                    lp_calls=[r.lp_calls for r in records],
                    warm_hits=[r.warm_hits for r in records],
                    modes=[r.router_mode for r in records],
                    solve_ms=[r.solve_ms for r in records],
                    tick_wall_ms=[w * 1e3 for w in walls],
                    max_dtotal=dtot, bottleneck_moved=len(moved))

    def lexmm_routed(self, cut, x_tsf):
        """``DistributedPSDSF(cut).routed_allocation("tsf")``: all active,
        after a departure, after the same user's return and with no
        change; modes warm, incremental, fallback, verify, the first
        equal to the lexmm solve ``x_tsf``."""
        import numpy as np
        from repro_torch.core.dynamic import DistributedPSDSF
        dyn = DistributedPSDSF(cut, device=self.device)
        user = int(np.argmax(x_tsf.sum(axis=1)))
        modes, xs, walls = [], [], []
        for change in (None, (user, False), (user, True), None):
            if change is not None:
                dyn.set_active(*change)
            t0 = time.perf_counter()
            xs.append(dyn.routed_allocation("tsf").x)
            walls.append(time.perf_counter() - t0)
            st = dyn.router_stats
            modes.append(st.mode)
            print(f"    routed_allocation after {change or 'no change'}: "
                  f"mode {st.mode}, {st.stages} stages, lp_calls "
                  f"{st.lp_calls}, warm_hits {st.warm_hits}, "
                  f"{walls[-1]:.3f} s")
        d_first = float(np.abs(xs[0] - x_tsf).max())
        d_last = float(np.abs(xs[3].sum(axis=1) - xs[0].sum(axis=1)).max())
        self.check(modes == ["warm", "incremental", "fallback", "verify"]
                   and d_first <= F64_ATOL
                   and d_last <= 1e-6 * max(1.0, float(xs[0].max())),
                   f"routed_allocation: modes {modes}, |dx| {d_first:.2e} "
                   f"/ {d_last:.2e}")
        return dict(modes=modes, walls_s=walls)

    def sched_fleets(self):
        """The scheduler phase's seeded fleets, at the scale PERF.md
        section 1 names (about 20,000 tenants on 256 servers; 800 on 32 in
        a rehearsal): 256 ``TPUPod``s of 16 kinds (4 generations x 4 slice
        sizes, HBM a chip by generation, DCN on some), two failed and
        three degraded, and 20,000 ``TenantJob``s allowed on one or two
        kinds, some with an HBM-per-chip floor or a DCN need; 256
        ``ReplicaGroup``s with 4k-128k context windows and 20,000
        ``Tenant``s."""
        import numpy as np
        from repro_torch.sched import (Cluster, ReplicaGroup, Tenant,
                                       TenantJob, TPUPod)
        rng = np.random.default_rng(23)
        n_srv, n_usr = (32, 800) if self.rehearse else (256, 20000)
        hbm = {"v4": 32.0, "v5e": 16.0, "v5p": 95.0, "v6e": 32.0}
        kinds = [(g, c) for g in hbm for c in (16, 64, 128, 256)]
        pods = []
        for i in range(n_srv):
            gen, chips = kinds[i % len(kinds)]
            pods.append(TPUPod(
                f"pod{i}", f"{gen}-{chips}", chips, hbm[gen],
                float(chips * rng.uniform(2.0, 6.0)),
                float(chips * rng.uniform(20.0, 60.0)),
                float(rng.choice([0.0, 25.0, 100.0]))))
        fleet = Cluster(pods)
        for i in rng.choice(n_srv, 5, replace=False)[:2]:
            fleet.mark_failed(f"pod{i}")
        for i in rng.choice(n_srv, 3, replace=False):
            fleet.degrade(f"pod{i}", float(rng.uniform(0.4, 0.9)))
        names = [f"{g}-{c}" for g, c in kinds]
        jobs = []
        for j in range(n_usr):
            chips = float(rng.choice([4.0, 8.0, 16.0]))
            allow = tuple(rng.choice(names, 1 if rng.random() < 0.85 else 2,
                                     replace=False))
            dcn = bool(rng.random() < 0.3)
            jobs.append(TenantJob(
                f"job{j}", float(rng.uniform(0.5, 2.0)), chips,
                chips * float(rng.uniform(4.0, 16.0)),
                chips * float(rng.uniform(1.0, 4.0)),
                chips * float(rng.uniform(5.0, 30.0)),
                float(rng.uniform(1.0, 10.0)) if dcn else 0.0,
                min_hbm_per_chip=float(rng.choice([0.0, 0.0, 24.0, 64.0])),
                generations=allow, needs_dcn=dcn))
        contexts = (4096, 8192, 32768, 131072)
        groups = [ReplicaGroup(
            f"group{i}", float(rng.choice([32, 64, 128, 256])),
            float(rng.uniform(40.0, 640.0)), float(rng.uniform(2e4, 2e5)),
            max_context=int(contexts[i % 4])) for i in range(n_srv)]
        tenants = []
        for t in range(n_usr):
            ctx = int(rng.choice([2048, 4096, 8192, 32768, 131072],
                                 p=[0.3, 0.3, 0.2, 0.15, 0.05]))
            tenants.append(Tenant(
                f"tenant{t}", float(rng.uniform(0.5, 2.0)), ctx,
                ctx / 8192 * float(rng.uniform(0.2, 1.0)),
                float(rng.uniform(256.0, 8192.0))))
        return fleet, jobs, groups, tenants

    def scheduler_path(self):
        """The scheduler layers on the seeded fleets: ``schedule_detail``
        (PS-DSF RDM, float64, Jacobi rounds of the bisect fill,
        ``max_rounds`` ``SCHED_ROUNDS`` at tol 1e-6, ``ensure_converged``
        on) on the dense layout and on the buckets, each with counts set to
        0 just before and read just after ((R+1) launches of the layout's
        fill kernel a round, R = 5) and held against its plain-driven
        twin, dense against bucketed (1e-9, equal rounds), and once at
        ``layout="auto"``; ``admitted_rates`` on the dispatch fleet the
        same way on the dense layout (R = 3); ``DynamicDispatcher``
        (float32, bisect) for full ticks and tenant churn on the card and
        on the CPU, its ``min_vds`` (one ``psdsf_vds`` launch) against the
        plain version; one ``schedule_detail`` profiled."""
        import numpy as np
        from repro_torch.core.layout import BucketedLayout
        from repro_torch.sched import (DynamicDispatcher, admitted_rates,
                                       dispatch_problem, schedule_detail)
        fleet, jobs, groups, tenants = self.sched_fleets()
        prob = fleet.problem(jobs)
        lay = BucketedLayout.from_cluster(fleet, jobs)
        print(f"  cluster {prob.num_users} jobs x {prob.num_servers} pods x "
              f"{prob.num_resources} resources: eligibility density "
              f"{lay.density:.4f}, bucket_max {lay.bucket_max}")
        kw = dict(fill="bisect", round="jacobi", max_rounds=SCHED_ROUNDS,
                  device=self.device)
        kernel = {"dense": "psdsf_fill", "bucketed": "psdsf_fill_bucketed"}
        counters = wrappers()
        total = {name: 0 for name in counters}
        runs = {}
        for layout in ("dense", "bucketed", "auto"):
            reset_counts(counters)
            self.sync()
            t0 = time.perf_counter()
            alloc, info = schedule_detail(fleet, jobs, layout=layout, **kw)
            self.sync()
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counters.items()}
            for name in counters:
                total[name] += launches[name]
            self.check_launches(
                launches, {kernel[info.layout]: (prob.num_resources + 1)
                           * info.rounds}, f"schedule {layout}")
            over = self.check_feasible(prob, alloc.x, f"schedule {layout}")
            print(f"  schedule_detail layout={layout} -> {info.layout}: "
                  f"{wall:.3f} s wall, {info.rounds} rounds, residual "
                  f"{info.residual:.3e} (converged {info.converged}, "
                  f"approx {info.approx}), bucket_max {info.bucket_max}, "
                  f"stranded {info.stranded_frac:.5f}, launches "
                  f"{launches[kernel[info.layout]]}, max(usage - capacity) "
                  f"{over:.3e}")
            runs[layout] = (alloc, info, wall)
            if layout == "auto":
                continue
            with self.plain_versions():
                plain, p_info = schedule_detail(fleet, jobs, layout=layout,
                                                **kw)
            diff = float(np.abs(plain.x - alloc.x).max())
            print(f"    vs plain-driven: max|dx|={diff:.3e}, rounds "
                  f"{p_info.rounds}")
            self.check(diff <= F64_ATOL and p_info.rounds == info.rounds,
                       f"schedule {layout}: kernel and plain runs disagree")
        (d_alloc, d_info, _), (b_alloc, b_info, _) = (runs["dense"],
                                                      runs["bucketed"])
        diff = float(np.abs(d_alloc.x - b_alloc.x).max())
        print(f"  dense vs bucketed: max|dx|={diff:.3e}, rounds "
              f"{d_info.rounds} / {b_info.rounds}")
        self.check(diff <= F64_ATOL and d_info.rounds == b_info.rounds,
                   "schedule: dense and bucketed disagree")
        # admitted_rates on the dispatch fleet, dense
        from repro_torch.core import engine
        dprob = dispatch_problem(groups, tenants)
        print(f"  dispatch {dprob.num_users} tenants x {dprob.num_servers} "
              f"groups: eligibility density "
              f"{float((dprob.eligibility > 0).mean()):.4f}")

        reset_counts(counters)
        self.sync()
        t0 = time.perf_counter()
        out = admitted_rates(groups, tenants, layout="dense", **kw)
        self.sync()
        r_wall = time.perf_counter() - t0
        r_launches = {name: fn.launches for name, fn in counters.items()}
        x_rates = np.array([list(out[t.name].values()) for t in tenants])
        for name in counters:
            total[name] += r_launches[name]
        # the plain-driven twin: the solve admitted_rates makes, with the
        # plain versions patched in (its info gives the rounds)
        with self.plain_versions():
            plain, p_info = engine.solve(dprob, layout="dense", **kw)
        self.check_launches(r_launches, {"psdsf_fill": (dprob.num_resources
                                                        + 1) * p_info.rounds},
                            "admitted_rates")
        self.check_feasible(dprob, x_rates, "admitted_rates")
        diff = float(np.abs(plain.x - x_rates).max())
        print(f"  admitted_rates: {r_wall:.3f} s wall (the solve and "
              f"{x_rates.size} dict entries), {p_info.rounds} rounds, "
              f"residual {p_info.residual:.3e}, launches "
              f"{r_launches['psdsf_fill']}, vs plain-driven "
              f"max|dx|={diff:.3e}")
        self.check(diff <= F64_ATOL, "admitted_rates: kernel and plain "
                                     "runs disagree")

        # DynamicDispatcher: ticks on the card and on the CPU
        churned = [t.name for t in tenants[:: max(1, len(tenants) // 8)]]

        def dispatch(device):
            disp = DynamicDispatcher(groups, tenants, precision="fast",
                                     fill="bisect", device=device)
            walls = []
            for step in range(3):
                if step == 2:
                    for name in churned:
                        disp.set_active(name, False)
                t0 = time.perf_counter()
                disp.tick()
                walls.append(time.perf_counter() - t0)
            return disp, walls

        reset_counts(counters)
        disp, walls = dispatch(self.device)
        mn, arg = disp.sim.min_vds()
        t_launches = {name: fn.launches for name, fn in counters.items()}
        for name in counters:
            total[name] += t_launches[name]
        self.check_launches(t_launches, {"psdsf_vds": 1},
                            "dispatcher ticks")
        with self.plain_versions():
            mn_p, arg_p = disp.sim.min_vds()
        self.check(bool(np.array_equal(mn, mn_p)),
                   "dispatcher min_vds: kernel and plain version differ")
        cpu, c_walls = dispatch("cpu")
        scale = max(1.0, float(np.abs(cpu.sim.x).max()))
        dx = float(np.abs(disp.sim.x - cpu.sim.x).max())
        print(f"  DynamicDispatcher layout={disp.sim.layout}: tick walls "
              f"{[round(w, 3) for w in walls]} s on the card, "
              f"{[round(w, 3) for w in c_walls]} s on the CPU ({len(churned)}"
              f" tenants departed before the third); min_vds equal to its "
              f"plain version; card vs CPU max|dx|={dx:.3e} (bound "
              f"{PATH_F32_REL * scale:.1e})")
        self.check(dx <= PATH_F32_REL * scale,
                   "dispatcher: card and CPU ticks disagree")
        self.check(not disp.sim.x[[t.name for t in tenants].index(
            churned[0])].any(), "a departed tenant kept its quota")
        prof = self.profile_window(
            "schedule_detail, dense", lambda: schedule_detail(
                fleet, jobs, layout="dense", **kw),
            {"psdsf_fill": "fill_event_kernel"})
        self.paths["scheduler"] = dict(
            launches=total, density=lay.density, bucket_max=lay.bucket_max,
            schedule={layout: dict(wall_s=w, rounds=i.rounds,
                                   residual=i.residual, layout=i.layout)
                      for layout, (_, i, w) in runs.items()},
            admitted_rates=dict(wall_s=r_wall, rounds=p_info.rounds,
                                residual=p_info.residual),
            dispatcher=dict(layout=disp.sim.layout, tick_walls_s=walls,
                            cpu_tick_walls_s=c_walls),
            profiled_schedule=prof)

    # -- attention kernels and the serving path -----------------------------
    def llm_config(self, layers=None, arch="qwen3_1_7b", opts=None):
        """``arch`` at full width in bfloat16 (its smoke config in a
        rehearsal), optionally cut to ``layers``, with the config fields
        ``opts`` sets (a sliding window, a cache dtype)."""
        from repro_torch.configs import get_config, get_smoke_config
        cfg = (get_smoke_config(arch) if self.rehearse
               else get_config(arch))
        if opts:
            cfg = dataclasses.replace(cfg, **opts)
        return dataclasses.replace(cfg, num_layers=layers) if layers else cfg

    def attn_inputs(self, shapes, dtype, seed):
        torch = self.torch
        g = torch.Generator(device=self.device).manual_seed(seed)
        return [torch.randn(s, generator=g, device=self.device).to(dtype)
                for s in shapes]

    def compare_attn(self, got, plain32, what, rel=ATTN_REL):
        """max |kernel - plain| against ``rel`` x max(1, max|plain|)
        (2^-8 for bfloat16 inputs)."""
        err = float((got.float() - plain32).abs().max())
        bound = rel * max(1.0, float(plain32.abs().max()))
        print(f"  {what}: max|kernel-plain f32|={err:.3e} (bound "
              f"{bound:.3e})")
        self.check(err <= bound, f"{what} disagrees with plain")
        return err

    def flash_cuda_core(self, call, plain, what, plain_lse=None):
        """``call`` (a float32 flash call the float32 tensor-core body
        takes) on the CUDA-core body it replaced, the wrapper's
        ``takes_tf32_body`` patched to refuse: run once, held against
        ``plain`` at ``ATTN_F32_REL`` (and against ``plain_lse`` at
        ``LSE_ATOL["float32"]`` where given), with exactly one launch on
        ``cuda_core_launches``. Returns the patched call, for timing, and
        its max |kernel - plain|."""
        from repro_torch.kernels.flash_attention import kernel

        def cuda_core():
            with mock.patch.object(kernel, "takes_tf32_body",
                                   lambda *a: False):
                return call()
        before = kernel.flash_attention.cuda_core_launches
        got = cuda_core()
        self.sync()
        if not self.rehearse:
            self.check(kernel.flash_attention.cuda_core_launches
                       == before + 1, f"{what}: the CUDA-core call missed "
                                      f"its body")
        out, lse = got if plain_lse is not None else (got, None)
        err = self.compare_attn(out, plain, f"{what}, cuda_core body",
                                ATTN_F32_REL)
        if lse is not None:
            lse_err = float((lse - plain_lse).abs().max())
            print(f"  {what}, cuda_core body: lse {lse_err:.3e} (bound "
                  f"{LSE_ATOL['float32']:.0e})")
            self.check(lse_err <= LSE_ATOL["float32"],
                       f"{what}, cuda_core body: lse disagrees with plain")
        return cuda_core, err

    @staticmethod
    def row_key(key, arch):
        """A kernel row's key: qwen3_1_7b's and mamba2_1_3b's shapes keep
        their plain keys (the kernels line's main rows), another arch's
        take ``@arch``."""
        return key if arch in ("qwen3_1_7b", "mamba2_1_3b") else \
            f"{key}@{arch}"

    def flash_vs_plain(self, arch="qwen3_1_7b", label="bfloat16"):
        """At ``arch``'s attention widths in ``label``'s dtype, S 1,024, a
        ragged 1,000, 512 (the profiled window's prompts) and 128 (the
        shortest prompt): each held against the plain version and timed in
        turns with SDPA in that dtype; each call must take its body. In
        bfloat16 that is the Hopper body (head dims 64, 128 and gemma_2b's
        256), bound at ``PEAK_BF16_FLOPS``, held at ``ATTN_REL``. In
        float32 it is the float32 tensor-core body (split TF32), held at
        ``ATTN_F32_REL``; the CUDA-core body it replaced is held against
        the same plain and timed in turns with it, and no time may beat
        the bound at ``PEAK_F32_TC_FLOPS``."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.flash_attention import kernel, ref
        cfg = self.llm_config(arch=arch)
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        f32 = label == "float32"
        dtype, el, rel, peak = (
            (torch.float32, 4, ATTN_F32_REL, PEAK_F32_TC_FLOPS) if f32
            else (torch.bfloat16, 2, ATTN_REL, PEAK_BF16_FLOPS))
        lengths = (128, 100, 64, 32) if self.rehearse else (1024, 1000, 512,
                                                             128)
        keys = [self.row_key(f"{label}{key}", arch)
                for key in ("", "_ragged", "_s512", "_s128")]
        fa = kernel.flash_attention
        body = self.flash_body_of(label, d)
        for key, s in zip(keys, lengths):
            q, k, v = self.attn_inputs([(1, s, hq, d), (1, s, hkv, d),
                                        (1, s, hkv, d)], dtype, seed=s)
            before = getattr(fa, body)
            got = fa(q, k, v)
            plain32 = ref.flash_attention(q.float(), k.float(), v.float())
            self.sync()
            if not self.rehearse:
                self.check(getattr(fa, body) == before + 1,
                           f"flash {label} S={s} missed its body, {body}")
            err = self.compare_attn(got, plain32, f"flash {label} S={s}",
                                    rel)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            ks, ls = self.interleaved(lambda: fa(q, k, v), sdpa, 20)
            ms, library_ms = sum(ks) / 2, sum(ls) / 2
            eager_ms = self.time_ms(lambda: fa(q, k, v), 20)
            library_eager_ms = self.time_ms(sdpa, 20)
            plain_ms = self.time_ms(lambda: ref.flash_attention(q, k, v), 5)
            extra = {}
            if f32:
                # in turns with the CUDA-core body it replaced
                cuda_core, cc_err = self.flash_cuda_core(
                    lambda: fa(q, k, v), plain32, f"flash {label} S={s}")
                ks2, cs = self.interleaved(lambda: fa(q, k, v), cuda_core,
                                           20)
                ks = ks + ks2
                extra = dict(library_computes="SDPA in float32",
                             cuda_core_ms=sum(cs) / 2, cuda_core_turns_ms=cs,
                             cuda_core_max_abs_err=cc_err)
            nbytes = (2 * hq + 2 * hkv) * s * d * el
            flops = 4 * hq * d * s * (s + 1) // 2
            t_bytes = nbytes / PEAK_BYTES_PER_S
            t_ops = flops / peak
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes > t_ops else "operations"
            bq = (kernel.TF32_BLOCK_ROWS if body == "tf32_launches"
                  else kernel.BLOCK_ROWS_D256 if d == 256
                  else kernel.block_rows(1, s, hq)
                  if body == "hopper_launches" else 64)
            print(f"  flash (1, {s}, {hq}/{hkv}, {d}) {label} causal, "
                  f"{body[:-9]} body, blocks of {bq} rows, kernel and SDPA "
                  f"in turns: kernel {ks[0]:.4f}, {ks[1]:.4f} ms, SDPA "
                  f"{ls[0]:.4f}, {ls[1]:.4f} ms"
                  + (f"; kernel {ks[2]:.4f}, {ks[3]:.4f} ms, CUDA-core body "
                     f"{extra['cuda_core_turns_ms'][0]:.4f}, "
                     f"{extra['cuda_core_turns_ms'][1]:.4f} ms" if f32
                     else "")
                  + f" (back to back: kernel {eager_ms:.4f}, SDPA "
                  f"{library_eager_ms:.4f} ms), plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.5f} ms ({nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e9:.3f} GFLOP at {peak / 1e12:.0f} TFLOP/s: "
                  f"bound by {bound_by})")
            if f32:
                self.check(self.rehearse or min(ks + [eager_ms]) >= bound_ms,
                           f"flash {label} S={s}: a measured time under its "
                           f"bound")
            self.rows[("flash_attention", key)] = dict(
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err,
                library_ms=library_ms, library_eager_ms=library_eager_ms,
                turns_ms=ks, library_turns_ms=ls, block_rows=bq,
                body=body[:-9], shape=f"1x{s}x{hq}/{hkv}x{d}", **extra)

    @staticmethod
    def decode_takes_tc(cfg):
        """Whether ``cfg``'s decode steps take the decode kernel's
        tensor-core body: a bfloat16 q (q comes out of the projections in
        the params' dtype promoted with the activations') at a group and
        head dim the body takes (the caches are contiguous: their rows are
        16-byte chunks)."""
        from repro_torch.kernels.decode_attention import kernel
        if not cfg.has_mixer("attn"):
            return False
        rep = cfg.num_heads // cfg.num_kv_heads
        return (cfg.dtype == cfg.param_dtype == "bfloat16"
                and kernel.TC_MIN_GROUP <= rep <= kernel.MAX_GROUP
                and cfg.head_dim in kernel.TC_HEAD_DIMS)

    @staticmethod
    def flash_body(cfg):
        """The flash body ``cfg``'s prefills take: its counter's name on the
        wrapper. q, k and v come out of the projections in the params' dtype
        promoted with the activations': bfloat16 at a Hopper head dim (64,
        128, 256) takes the Hopper body, float32 (float32 params, or a dtype
        split with float32 params) at those head dims the float32
        tensor-core body, the rest the CUDA-core body."""
        bf16 = cfg.dtype == cfg.param_dtype == "bfloat16"
        return Smoke.flash_body_of("bfloat16" if bf16 else "float32",
                                   cfg.head_dim)

    @staticmethod
    def flash_body_of(label, d):
        """The counter of the flash body a contiguous ``label`` (bfloat16 or
        float32) input at head dim ``d`` takes."""
        from repro_torch.kernels.flash_attention import kernel
        if label == "bfloat16" and d in kernel.HOPPER_HEAD_DIMS:
            return "hopper_launches"
        if label == "float32" and d in kernel.TF32_HEAD_DIMS:
            return "tf32_launches"
        return "cuda_core_launches"

    def flash_plans(self):
        """The Hopper flash body at both block sizes (query rows a block)
        timed at the serving path's prompt lengths (graph replays), beside
        the one the wrapper picks: the measurement behind
        ``kernel.block_rows``; then at head dim 256 (gemma_2b's heads) in
        turns with the CUDA-core body that took it before."""
        if self.rehearse:
            print("rehearsal: no card, no plan timings")
            return
        torch = self.torch
        from repro_torch.kernels.flash_attention import kernel, ref
        cfg = self.llm_config()
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        table = {}
        for s in (128, 256, 512, 768, 1024):
            q, k, v = self.attn_inputs([(1, s, hq, d), (1, s, hkv, d),
                                        (1, s, hkv, d)], torch.bfloat16,
                                       seed=s)
            plain32 = ref.flash_attention(q.float(), k.float(), v.float())
            row = {}
            for bq in kernel.BLOCK_ROWS:
                with mock.patch.object(kernel, "block_rows",
                                       lambda b, s_, h, _bq=bq: _bq):
                    self.compare_attn(kernel.flash_attention(q, k, v),
                                      plain32, f"flash S={s} BQ {bq}")
                    row[f"BQ {bq}"] = self.time_ms(
                        lambda: kernel.flash_attention(q, k, v), 20,
                        graph=True)
            chosen = kernel.block_rows(1, s, hq)
            table[s] = dict(row, chosen=f"BQ {chosen}")
            print(f"  S={s}: " + ", ".join(f"{p} {ms:.4f} ms"
                                           for p, ms in row.items())
                  + f"; the wrapper picks BQ {chosen}")
        self.paths["flash_tile_plans"] = table
        # head dim 256 at gemma_2b's heads: the Hopper body's one layout
        # (64-row blocks and kv stages) in turns with the CUDA-core body it
        # replaced (the wrapper sent D 256 there before)
        gemma = self.llm_config(arch="gemma_2b")
        hq, hkv, d = gemma.num_heads, gemma.num_kv_heads, gemma.head_dim
        table = {}
        for s in (128, 512, 1024, 2048):
            q, k, v = self.attn_inputs([(1, s, hq, d), (1, s, hkv, d),
                                        (1, s, hkv, d)], torch.bfloat16,
                                       seed=s)
            plain32 = ref.flash_attention(q.float(), k.float(), v.float())
            self.compare_attn(kernel.flash_attention(q, k, v), plain32,
                              f"flash D 256 S={s}")

            def old_body():
                with mock.patch.object(kernel, "HOPPER_HEAD_DIMS", (64, 128)):
                    return kernel.flash_attention(q, k, v)
            ks, cs = self.interleaved(lambda: kernel.flash_attention(q, k, v),
                                      old_body, 20)
            table[s] = {"hopper BQ 64": ks, "cuda_core": cs}
            print(f"  gemma_2b 8/1 x 256, S={s}: Hopper body (BQ "
                  f"{kernel.BLOCK_ROWS_D256}) {ks[0]:.4f}, "
                  f"{ks[1]:.4f} ms; CUDA-core body in the same turns "
                  f"{cs[0]:.4f}, {cs[1]:.4f} ms")
        self.paths["flash_tile_plans_d256"] = table

    def decode_vs_plain(self, arch="qwen3_1_7b"):
        """At ``arch``'s attention widths: the serving shape (8 slots of a
        2,048-row cache, one length per slot: 1, the whole cache, past the
        cache, ragged), then one long sequence (1 x 32,768 rows), where
        splitting the rows matters most."""
        cfg = self.llm_config(arch=arch)
        long_rows = 256 if self.rehearse else 32768
        self.decode_case(self.row_key("bfloat16", arch), cfg, 8,
                         64 if self.rehearse else 2048)
        self.decode_case(self.row_key("bfloat16_long", arch), cfg, 1,
                         long_rows, lens=[long_rows - 3])

    def decode_case(self, key, cfg, b, s_max, lens=None):
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.decode_attention import kernel, ref
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        dtype = torch.bfloat16
        q, kc, vc = self.attn_inputs([(b, hq, d), (b, s_max, hkv, d),
                                      (b, s_max, hkv, d)], dtype, seed=3)
        if lens is None:
            lens = [1, s_max, s_max + 37, s_max // 2 + 3, s_max // 4 + 1, 64,
                    3 * s_max // 4 - 5, s_max - 1]
        kv_len = torch.tensor(lens, dtype=torch.int32, device=self.device)
        tc_before = kernel.decode_attention.tc_launches
        got = kernel.decode_attention(q, kc, vc, kv_len)
        tc = kernel.decode_attention.tc_launches - tc_before
        body = "tensor_core" if self.decode_takes_tc(cfg) else "cuda_core"
        if not self.rehearse:
            self.check(tc == (body == "tensor_core"),
                       f"decode {b}x{s_max}: {tc} tensor-core launches, "
                       f"expected the {body} body")
        plain32, lse32 = ref.decode_attention(q.float(), kc.float(),
                                              vc.float(), kv_len,
                                              return_lse=True)
        # the heads' log-sum-exps, which a split-KV decode merges by
        got_lse, lse = kernel.decode_attention(q, kc, vc, kv_len,
                                               return_lse=True)
        self.sync()
        err = self.compare_attn(got, plain32, f"decode {b}x{s_max}")
        lse_err = float((lse - lse32).abs().max())
        same = torch.equal(got_lse, got)
        print(f"  decode {b}x{s_max} lse: max|kernel-plain f32|="
              f"{lse_err:.3e} (bound {LSE_ATOL['bfloat16']:.0e}); output "
              f"equal to the call without it: {same}")
        self.check(lse_err <= LSE_ATOL["bfloat16"] and same,
                   f"decode {b}x{s_max} lse disagrees with plain")
        valid = [min(n, s_max) for n in lens]
        top = max(valid)
        qt = q[:, :, None, :]
        kt, vt = (t[:, :top].transpose(1, 2) for t in (kc, vc))
        mask = (torch.arange(top, device=self.device)[None, :]
                < kv_len.clamp(max=s_max)[:, None])[:, None, None, :]

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                  enable_gqa=True)

        def kern():
            return kernel.decode_attention(q, kc, vc, kv_len)
        ks, ls = self.interleaved(kern, sdpa, 50)
        ms, library_ms = sum(ks) / 2, sum(ls) / 2
        eager_ms = self.time_ms(kern, 50)
        library_eager_ms = self.time_ms(sdpa, 50)
        plain_ms = self.time_ms(lambda: ref.decode_attention(q, kc, vc,
                                                             kv_len), 10)
        nbytes = 2 * sum(valid) * hkv * d * 2 + 2 * b * hq * d * 2 + b * 4
        flops = 4 * sum(valid) * hq * d
        bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                       flops / PEAK_BF16_FLOPS) * 1e3
        chunk = (kernel.chunk_rows_tc(b, s_max, hkv, d) if tc
                 else kernel.chunk_rows(b, s_max, hkv))
        blocks = b * hkv * -(-s_max // chunk)
        print(f"  decode ({b} slots, {s_max} rows, {hq}/{hkv}, {d}) bf16, "
              f"{body} body, lengths {valid}; {blocks} blocks of {chunk} "
              f"rows; kernel and "
              f"SDPA on the valid prefix in turns: kernel {ks[0]:.4f}, "
              f"{ks[1]:.4f} ms, SDPA {ls[0]:.4f}, {ls[1]:.4f} ms (back to "
              f"back: kernel {eager_ms:.4f}, SDPA {library_eager_ms:.4f} ms),"
              f" plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({nbytes / 1e6:.2f} MB: bound by bytes)")
        self.rows[("decode_attention", key)] = dict(
            ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by="bytes", max_abs_err=err, library_ms=library_ms,
            library_eager_ms=library_eager_ms, turns_ms=ks,
            library_turns_ms=ls, blocks=blocks, lse_max_abs_err=lse_err,
            body=body, shape=f"{b}x{s_max}x{hq}/{hkv}x{d}")

    def decode_plans(self):
        """The decode kernel's tensor-core body at chunks of 64 to 2,048
        rows, at gemma_2b's 8/1 x 256 and qwen2_5_32b's 40/8 x 128, over 8
        slots of 2,048 rows (the serving lengths) and one of 32,768 (graph
        replays), beside the chunk the wrapper picks: the measurement
        behind ``kernel.chunk_rows_tc``."""
        if self.rehearse:
            print("rehearsal: no card, no plan timings")
            return
        torch = self.torch
        from repro_torch.kernels.decode_attention import kernel, ref
        table = {}
        for arch in ("gemma_2b", "qwen2_5_32b"):
            cfg = self.llm_config(arch=arch)
            hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            for b, s_max, lens in ((8, 2048, None), (1, 32768, [32765])):
                lens = lens or [1, s_max, s_max + 37, s_max // 2 + 3,
                                s_max // 4 + 1, 64, 3 * s_max // 4 - 5,
                                s_max - 1]
                q, kc, vc = self.attn_inputs(
                    [(b, hq, d), (b, s_max, hkv, d), (b, s_max, hkv, d)],
                    torch.bfloat16, seed=3)
                kv_len = torch.tensor(lens, dtype=torch.int32,
                                      device=self.device)
                plain32 = ref.decode_attention(q.float(), kc.float(),
                                               vc.float(), kv_len)
                row = {}
                for chunk in (64, 128, 256, 512, 1024, 2048):
                    with mock.patch.object(kernel, "chunk_rows",
                                           lambda *a, c=chunk: c):
                        self.compare_attn(
                            kernel.decode_attention(q, kc, vc, kv_len),
                            plain32, f"decode {arch} {b}x{s_max} chunk "
                                     f"{chunk}")
                        row[chunk] = self.time_ms(
                            lambda: kernel.decode_attention(q, kc, vc,
                                                            kv_len),
                            20, graph=True)
                chosen = kernel.chunk_rows_tc(b, s_max, hkv, d)
                table[f"{arch} {b}x{s_max}"] = dict(row, chosen=chosen)
                print(f"  {arch} {hq}/{hkv} x {d}, {b}x{s_max}: "
                      + ", ".join(f"chunk {c} {ms:.4f} ms"
                                  for c, ms in row.items())
                      + f"; the wrapper picks {chosen}")
        self.paths["decode_chunk_plans"] = table

    @staticmethod
    def serving_launches(cfg, prefills, steps):
        """Launches the serving path must make: each attention layer one
        ``flash_attention`` per prefill and one ``decode_attention`` per
        step, each mamba layer one ``ssd_scan`` per prefill."""
        pattern = cfg.block_pattern
        kinds = [pattern[i % len(pattern)][0] for i in range(cfg.num_layers)]
        attn, mamba = kinds.count("attn"), kinds.count("mamba")
        return {"flash_attention": attn * prefills,
                "decode_attention": attn * steps,
                "ssd_scan": mamba * prefills}

    def serving(self, arch="qwen3_1_7b", path="serving", layers=None,
                requests=16, new_tokens=32, opts=None):
        """The serving path of ``arch`` (cut to ``layers`` where given, with
        the config fields ``opts`` sets): ``requests`` requests of
        ``new_tokens`` new tokens each, counts set to 0 just before ``run``
        and read just after."""
        import numpy as np
        torch = self.torch
        from repro_torch.models import model as tmodel
        from repro_torch.serve import ServingEngine
        from repro_torch.serve import engine as engine_mod
        cfg = self.llm_config(layers, arch=arch, opts=opts)
        max_len, (lo, hi), max_new = ((64, (8, 40), 4) if self.rehearse
                                      else (2048, (128, 1024), new_tokens))
        self.free_full_model()            # an earlier model's params
        if self.device.type == "cuda":
            print(f"  device memory before the load: "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                  f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} "
                  f"GiB reserved")
        t0 = time.perf_counter()
        params = tmodel.init_params(cfg, 0, device=self.device)
        self.sync()
        n_params = sum(p.numel() for p in params.parameters())
        n_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
        parts = []
        if cfg.has_mixer("attn"):
            parts.append(f"{cfg.num_heads}/{cfg.num_kv_heads} heads x "
                         f"{cfg.head_dim}, d_ff {cfg.d_ff}")
        if cfg.has_mixer("mamba"):
            parts.append(f"d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM heads "
                         f"x {cfg.ssm_headdim}, state {cfg.ssm_state}, "
                         f"chunk {cfg.ssm_chunk}")
        if cfg.has_moe():
            parts.append(f"MoE {cfg.moe_experts} experts top-"
                         f"{cfg.moe_top_k} x d_ff {cfg.expert_d_ff} "
                         f"({cfg.mlp_type}, {cfg.moe_impl}), "
                         f"{sum(b[1] == 'moe' for b in cfg.block_pattern)} "
                         f"of {len(cfg.block_pattern)} layers")
        if cfg.sliding_window or cfg.cache_dtype:
            parts.append(f"sliding window {cfg.sliding_window}, KV cache "
                         f"{cfg.cache_dtype or cfg.dtype}")
        if cfg.param_dtype != cfg.dtype:
            parts.append(f"params {cfg.param_dtype} over {cfg.dtype} "
                         f"activations, KV cache "
                         f"{cfg.cache_dtype or cfg.dtype}")
        widths = "; ".join(parts)
        full = self.llm_config(arch=arch)
        cut = (f" (the config's {full.num_layers}: {full.param_count()} "
               f"params)" if full.num_layers != cfg.num_layers else "")
        print(f"  {cfg.name}: {cfg.num_layers} layers{cut}, d_model "
              f"{cfg.d_model}, {widths}, vocab {cfg.vocab_size} (padded "
              f"{cfg.vocab_padded}), {cfg.dtype}: {n_params} params, "
              f"{n_bytes / 1e9:.3f} GB; seeded init "
              f"{time.perf_counter() - t0:.2f} s")
        # warm-up outside the engine (cuBLAS handles, the kernels' loads)
        tmodel.forward_prefill(cfg, params, [[1] * 70], device=self.device)
        tmodel.forward_decode(cfg, params, tmodel.init_caches(
            cfg, 2, 80, device=self.device), [1, 2], 70, device=self.device)
        self.params_full, self.cfg_full = params, cfg

        eng = ServingEngine(cfg, params=params, max_slots=8, max_len=max_len,
                            tenant_weights={"gold": 2.0, "free": 1.0},
                            device=self.device)
        rng = np.random.default_rng(0)
        for i in range(requests):
            tenant = "gold" if i % 3 else "free"
            n = int(rng.integers(lo, hi + 1))
            eng.submit(tenant, [int(t) for t in rng.integers(
                0, cfg.vocab_size, n)], max_new_tokens=max_new)
        finite = []

        def watch(fn):
            def call(*a, **k):
                logits, caches = fn(*a, **k)
                finite.append(torch.isfinite(logits).all())
                return logits, caches
            return call
        counters = wrappers()
        with mock.patch.object(engine_mod, "forward_prefill",
                               watch(engine_mod.forward_prefill)), \
                mock.patch.object(engine_mod, "forward_decode",
                                  watch(engine_mod.forward_decode)):
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            reset_counts(counters)
            self.sync()
            t0 = time.perf_counter()
            done = eng.run(max_steps=requests * max_new + 64)
            self.sync()
            wall = time.perf_counter() - t0
            launches = {name: fn.launches for name, fn in counters.items()}
            bodies = {attr: getattr(counters["flash_attention"], attr)
                      for attr in BODY_COUNTS}
            variants = {f"{name}.{attr}": getattr(counters[name], attr)
                        for name in ("flash_attention", "decode_attention")
                        for attr in VARIANT_COUNTS
                        if hasattr(counters[name], attr)}
            decode_tc = counters["decode_attention"].tc_launches
        st = eng.stats
        per_tenant = {}
        for r in done:
            per_tenant[r.tenant] = per_tenant.get(r.tenant, 0) \
                + len(r.out_tokens)
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if self.device.type == "cuda" else None)
        print(f"  served {len(done)} requests in {wall:.3f} s: "
              f"{st['prefills']} prefills of {st['prefill_tokens']} tokens "
              f"({st['prefill_s'] * 1e3 / st['prefills']:.2f} ms per request,"
              f" {st['prefill_tokens'] / st['prefill_s']:.0f} tokens/s), "
              f"{st['decode_steps']} decode steps "
              f"({st['decode_s'] * 1e3 / st['decode_steps']:.3f} ms per step, "
              f"{st['decode_tokens'] / st['decode_s']:.1f} tokens/s, "
              f"{st['decode_tokens'] / st['decode_steps']:.2f} active slots "
              f"per step)")
        print(f"  tokens per tenant: {per_tenant}; launches: {launches}; "
              f"flash_attention by body: {bodies}; decode_attention on the "
              f"tensor-core body: {decode_tc}; windowed, float8 and "
              f"mixed-dtype launches: {variants}"
              + (f"; peak device memory {peak:.2f} GiB" if peak else ""))
        self.paths[path] = dict(
            launches=launches, flash_bodies=bodies, variants=variants,
            decode_tc_launches=decode_tc, wall_s=wall,
            requests=len(done), layers=cfg.num_layers, params=n_params,
            new_tokens=max_new,
            prefills=st["prefills"], prefill_tokens=st["prefill_tokens"],
            prefill_ms_per_request=st["prefill_s"] * 1e3 / st["prefills"],
            prefill_tokens_per_s=st["prefill_tokens"] / st["prefill_s"],
            decode_steps=st["decode_steps"],
            decode_step_ms=st["decode_s"] * 1e3 / st["decode_steps"],
            decode_tokens_per_s=st["decode_tokens"] / st["decode_s"],
            tokens_per_tenant=per_tenant, peak_gib=peak)

        self.check(len(done) == requests and all(
            r.done and len(r.out_tokens) == max_new for r in done),
            "not every request completed")
        self.check(all(0 <= t < cfg.vocab_size for r in done
                       for t in r.out_tokens), "a token id outside the vocab")
        self.check(bool(torch.stack(finite).all()), "non-finite logits")
        if not self.rehearse:
            want = self.serving_launches(cfg, st["prefills"], eng._steps)
            for name, count in launches.items():
                self.check(count == want.get(name, 0),
                           f"{name} launched {count} times on the serving "
                           f"path, expected {want.get(name, 0)}")
            # every prefill's attention took the Hopper (TMA + wgmma) body,
            # gemma_2b's head dim 256 too, a float32 q the CUDA-core body;
            # every decode step at groups of 2-16 under a bfloat16 q the
            # tensor-core body
            body = self.flash_body(cfg)
            want_bodies = dict.fromkeys(BODY_COUNTS, 0)
            want_bodies[body] = want["flash_attention"]
            self.check(bodies == want_bodies,
                       f"flash_attention bodies {bodies}, expected every "
                       f"launch on the {body[:-9]} body")
            want_tc = (want["decode_attention"] if self.decode_takes_tc(cfg)
                       else 0)
            self.check(decode_tc == want_tc,
                       f"decode_attention took the tensor-core body "
                       f"{decode_tc} times, expected {want_tc}")
            # a window reaches every flash and decode launch, a float8
            # cache every decode launch, a float32 q over a bfloat16 cache
            # (float32 params over bfloat16 activations) every decode
            # launch; none reaches any otherwise
            fp8 = cfg.cache_dtype in FP8_CACHES
            mixed = (not cfg.cache_dtype and cfg.dtype == "bfloat16"
                     and cfg.param_dtype == "float32")
            want_variants = {
                "flash_attention.window_launches":
                    want["flash_attention"] if cfg.sliding_window else 0,
                "decode_attention.window_launches":
                    want["decode_attention"] if cfg.sliding_window else 0,
                "decode_attention.fp8_launches":
                    want["decode_attention"] if fp8 else 0,
                "decode_attention.mixed_launches":
                    want["decode_attention"] if mixed else 0}
            self.check(variants == want_variants,
                       f"windowed, float8 and mixed-dtype launches "
                       f"{variants}, expected {want_variants}")

    def serving_profile(self, path="serving", requests=8, new_tokens=8):
        """Device busy and idle share over a short serving window of the
        model the last serving phase ran: ``requests`` requests of 512
        prompt tokens, ``new_tokens`` new tokens each. Each MoE layer runs
        inside a ``moe_layer`` profiler range, whose device time (the
        kernels launched inside it) gives the MoE layers' share of the busy
        time."""
        import numpy as np
        from torch.profiler import ProfilerActivity, profile, record_function
        from repro_torch.models import blocks as blocks_mod
        from repro_torch.serve import ServingEngine
        cfg = self.cfg_full
        moe_apply = blocks_mod.moe_apply_torch

        def moe_ranged(*a, **k):
            with record_function("moe_layer"):
                return moe_apply(*a, **k)
        prompt = 24 if self.rehearse else 512
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        rng = np.random.default_rng(1)
        eng = ServingEngine(cfg, params=self.params_full, max_slots=8,
                            max_len=prompt + 16,
                            tenant_weights={"gold": 2.0, "free": 1.0},
                            device=self.device)
        for i in range(requests):
            eng.submit("gold" if i % 3 else "free", [int(t) for t in rng.integers(
                0, cfg.vocab_size, prompt)], max_new_tokens=new_tokens)
        self.sync()
        with profile(activities=acts) as prof, \
                mock.patch.object(blocks_mod, "moe_apply_torch", moe_ranged):
            t0 = time.perf_counter()       # the run, not the trace's export
            eng.run(max_steps=64)
            self.sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # kernels only: the range's own span on the device timeline (a
        # user annotation) is not device work
        kernels, moe_us = profiled_device_times(prof, "moe_layer")
        rows = sorted(((us, key, count) for key, (us, count)
                       in kernels.items()), reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3
        moe_ms = moe_us / 1e3
        st = eng.stats
        print(f"  profiled window: {st['prefills']} prefills x {prompt} "
              f"tokens, {st['decode_steps']} decode steps: wall "
              f"{wall_ms:.1f} ms (prefill {st['prefill_s'] * 1e3:.1f}, decode"
              f" {st['decode_s'] * 1e3:.1f})")
        if busy_ms <= 0:
            print("  profiler saw no device time: not measured")
            return
        attn = {name: sum(r[0] for r in rows if key in r[1]) / 1e3
                for name, key in (("flash_attention", "flash_"),
                                  ("decode_attention", "decode_"),
                                  ("ssd_scan", "ssd_"))}
        print(f"  device busy {busy_ms:.1f} ms, idle share "
              f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; "
              + ", ".join(f"{name} {ms:.2f} ms" for name, ms in attn.items())
              + ("" if not cfg.has_moe() else
                 f"; MoE layers {moe_ms:.2f} ms, {moe_ms / busy_ms:.3f} of "
                 f"busy" if moe_ms > 0 else "; MoE layers: not measured"))
        for us, key, count in rows[:10]:
            print(f"    {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
        self.paths[path]["profile"] = dict(
            wall_ms=wall_ms, busy_ms=busy_ms,
            idle_share=max(0.0, 1 - busy_ms / wall_ms), **attn,
            prefill_ms=st["prefill_s"] * 1e3, decode_ms=st["decode_s"] * 1e3,
            prefills=st["prefills"], decode_steps=st["decode_steps"],
            moe_ms=moe_ms if cfg.has_moe() else None)

    def free_full_model(self):
        """Drop the last serving phase's model and return its memory to the
        card before another model loads."""
        import gc
        self.params_full = self.cfg_full = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def serving_vs_plain(self, arch="qwen3_1_7b", opts=None, key=None):
        """A 2-layer full-width ``arch`` (with the config fields ``opts``
        sets), the kernels' run then the plain versions' run, on the same
        params and tokens (the default positions: (3, B, S) under
        M-RoPE); the two sequences decode 7 positions apart."""
        import numpy as np
        torch = self.torch
        from repro_torch.kernels.decode_attention import ref as decode_ref
        from repro_torch.kernels.flash_attention import ref as flash_ref
        from repro_torch.models import attention as attention_mod
        from repro_torch.models import model as tmodel
        from repro_torch.models.common import to_cache_dtype_torch
        cfg = self.llm_config(layers=2, arch=arch, opts=opts)
        if arch != "qwen3_1_7b" or opts:
            self.free_full_model()
        params = tmodel.init_params(cfg, 1, device=self.device)
        s, max_len, steps = (20, 32, 4) if self.rehearse else (300, 512, 4)
        rng = np.random.default_rng(2)
        prompt = rng.integers(0, cfg.vocab_size, (2, s))
        feed = rng.integers(0, cfg.vocab_size, (steps, 2))

        def run():
            logits, caches = tmodel.forward_prefill(cfg, params, prompt,
                                                    device=self.device)
            pool = tmodel.init_caches(cfg, 2, max_len, device=self.device)
            for one, kv in zip(pool, caches):
                for name in ("k", "v"):
                    one[name][:, :s] = to_cache_dtype_torch(kv[name],
                                                            one[name].dtype)
            out = [logits]
            pos = torch.tensor([s, s + 7], dtype=torch.int32,
                               device=self.device)
            for tok in feed:
                logits, pool = tmodel.forward_decode(
                    cfg, params, pool, tok, pos, device=self.device)
                out.append(logits)
                pos += 1
            self.sync()
            return out

        counters = wrappers()
        reset_counts(counters)
        kern = run()
        kern_launches = {n: fn.launches for n, fn in counters.items()}
        with mock.patch.object(attention_mod, "flash_attention",
                               flash_ref.flash_attention), \
                mock.patch.object(attention_mod, "decode_attention",
                                  lambda q, kc, vc, n, kv_start=None:
                                  decode_ref.decode_attention(
                                      q[:, 0], kc, vc, n,
                                      kv_start=kv_start)[:, None]):
            plain = run()
        plain_launches = {n: fn.launches for n, fn in counters.items()}
        print(f"  2-layer {cfg.name} {cfg.dtype}, prompt 2 x {s}, {steps} "
              f"decode steps (window {cfg.sliding_window}, cache "
              f"{cfg.cache_dtype or cfg.dtype}): launches with kernels "
              f"{kern_launches}")
        key = key or ("serving_vs_plain" if arch == "qwen3_1_7b"
                      else f"serving_{arch}_vs_plain")
        self.paths[key] = dict(
            max_abs_err=self.compare_logits(cfg, kern, plain))
        if not self.rehearse:
            self.check(kern_launches["flash_attention"] == 2
                       and kern_launches["decode_attention"] == 2 * steps,
                       f"kernel launches {kern_launches}")
            self.check(plain_launches == kern_launches,
                       "the plain run launched a kernel")

    def frontend_stub(self, arch):
        """A 2-layer full-width ``arch`` whose first 64 positions come from
        precomputed embeddings (``forward_prefill``'s ``extra_embeds`` and
        ``extra_mask``): qwen2_vl_72b's vision patches on an 8 x 8 grid with
        3-D M-RoPE ids (t constant, h and w the grid) and the text after
        them, every component counting on from the grid's largest id;
        musicgen_large's audio frames with 1-D positions. The kernels' run,
        then the plain versions' run, on the same params and inputs; their
        logits held to 2^-5 x max|logit|."""
        import numpy as np
        torch = self.torch
        from repro_torch.kernels.flash_attention import ref as flash_ref
        from repro_torch.models import attention as attention_mod
        from repro_torch.models import model as tmodel
        cfg = self.llm_config(layers=2, arch=arch)
        self.free_full_model()
        params = tmodel.init_params(cfg, 2, device=self.device)
        (gh, gw), s, b = ((2, 4), 20, 2) if self.rehearse else ((8, 8), 300,
                                                                 2)
        n = gh * gw
        rng = np.random.default_rng(3)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                 device=self.device)
        # embeddings on the table's scale (std 1 / sqrt(d_model))
        g = torch.Generator(device=self.device).manual_seed(4)
        extra = (torch.randn(b, s, cfg.d_model, generator=g,
                             device=self.device) * cfg.d_model ** -0.5
                 ).to(params.embed.dtype)
        mask = torch.zeros(b, s, dtype=torch.bool, device=self.device)
        mask[:, :n] = True
        text = torch.arange(s - n, device=self.device)
        if cfg.rope_type == "mrope":
            grid = torch.arange(n, device=self.device)
            text = text + max(gh, gw)
            comps = [torch.cat([torch.zeros_like(grid), text]),
                     torch.cat([grid // gw, text]),
                     torch.cat([grid % gw, text])]
            pos = torch.stack(comps)[:, None].expand(3, b, s)
        else:
            pos = torch.arange(s, device=self.device).expand(b, s)

        def run():
            logits, _ = tmodel.forward_prefill(cfg, params, tokens, pos,
                                               extra, mask,
                                               device=self.device)
            self.sync()
            return [logits]

        counters = wrappers()
        reset_counts(counters)
        kern = run()
        kern_launches = {k: fn.launches for k, fn in counters.items()}
        with mock.patch.object(attention_mod, "flash_attention",
                               flash_ref.flash_attention):
            plain = run()
        plain_launches = {k: fn.launches for k, fn in counters.items()}
        # the stub's embeddings reached the model: without them the logits
        # move
        without, _ = tmodel.forward_prefill(cfg, params, tokens, pos,
                                            device=self.device)
        moved = float((without - kern[0]).abs().max())
        print(f"  2-layer {cfg.name} {cfg.dtype} ({cfg.frontend}), {b} x "
              f"{s} positions, the first {n} from extra_embeds"
              + (f" on a {gh} x {gw} grid, M-RoPE positions" if
                 cfg.rope_type == "mrope" else ", 1-D positions")
              + f"; launches with the kernels {kern_launches}; logits "
              f"without the embeddings move by {moved:.3e}")
        self.paths[f"frontend_stub_{arch}"] = dict(
            max_abs_err=self.compare_logits(cfg, kern, plain),
            stub_positions=n, positions=s, logits_moved=moved)
        self.check(moved > 0, "the stub's embeddings changed nothing")
        if not self.rehearse:
            self.check(kern_launches["flash_attention"] == 2,
                       f"kernel launches {kern_launches}")
            self.check(plain_launches == kern_launches,
                       "the plain run launched a kernel")

    def compare_logits(self, cfg, kern, plain, argmax=False):
        """Max |kernel-driven - plain-driven| over a run's logits, each step
        held to 2^-5 x max|logit| (and, with ``argmax``, to equal
        argmaxes)."""
        torch = self.torch
        errs = []
        for i, (a, b) in enumerate(zip(kern, plain)):
            # the padded vocab slots read -1e9 in both runs
            a, b = a[:, :cfg.vocab_size], b[:, :cfg.vocab_size]
            err = float((a - b).abs().max())
            bound = LOGIT_REL * float(b.abs().max())
            same = bool((a.argmax(-1) == b.argmax(-1)).all())
            errs.append(err)
            print(f"  {'prefill' if i == 0 else f'decode {i}'} logits: "
                  f"max|kernels-plain|={err:.4e} (bound {bound:.4e}, "
                  f"max|logit| {float(b.abs().max()):.3f}), argmax equal: "
                  f"{same}")
            self.check(bool(torch.isfinite(a).all()) and err <= bound,
                       "kernel-driven and plain-driven logits disagree")
            self.check(same or not argmax,
                       "kernel-driven and plain-driven argmaxes differ")
        return max(errs)

    # -- the SSD kernel and the Mamba-2 serving path -------------------------
    def ssd_vs_plain(self, arch="mamba2_1_3b"):
        """``ssd_scan`` through ``ops.ssd_chunked``, the main path's call, in
        the main path's layout at ``arch``'s widths: x, B and C slices of
        one (1, S, d_inner + 2 N) conv output, dt (1, S, H), y written
        through strides."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.ssd_scan import kernel, ops, ref
        cfg = self.llm_config(arch=arch)
        h, p, n, q = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, \
            cfg.ssm_chunk
        di = h * p
        s_full, s_ragged, s_half = ((64, 50, 32) if self.rehearse
                                    else (1024, 1000, 512))
        for key, s, dtype in (("bfloat16", s_full, torch.bfloat16),
                              ("bfloat16_ragged", s_ragged, torch.bfloat16),
                              ("bfloat16_s512", s_half, torch.bfloat16),
                              ("float32", s_full, torch.float32)):
            key = self.row_key(key, arch)
            g = torch.Generator(device=self.device).manual_seed(s)

            def randn(*shape):
                return torch.randn(shape, generator=g, device=self.device)
            # the JAX ssd tests' distribution: dt softplus / 2, a in
            # -exp(0.3 N(0, 1)), B and C at 0.5 N(0, 1)
            xbc = randn(1, s, di + 2 * n)
            xbc[..., di:] /= 2
            xbc = xbc.to(dtype)
            x = xbc[..., :di].reshape(1, s, h, p)
            bm, cm = xbc[..., di:di + n], xbc[..., di + n:]
            dt = F.softplus(randn(1, s, h)) / 2
            a = -torch.exp(randn(h) * 0.3)
            y, state = ops.ssd_chunked(x, dt, a, bm, cm, chunk=q)
            y_plain, state_plain = ref.ssd_scan(
                x.transpose(1, 2).float(), dt.transpose(1, 2), a,
                bm.float(), cm.float(), chunk=q)
            self.sync()
            label = "bfloat16" if dtype == torch.bfloat16 else "float32"
            err = float((y.transpose(1, 2).float() - y_plain).abs().max())
            bound = SSD_REL[label] * max(1.0, float(y_plain.abs().max()))
            s_err = float((state - state_plain).abs().max())
            s_bound = SSD_REL["float32"] * max(
                1.0, float(state_plain.abs().max()))
            print(f"  ssd {key} S={s}: y max|kernel-plain f32|={err:.3e} "
                  f"(bound {bound:.3e}), final state {s_err:.3e} (bound "
                  f"{s_bound:.3e})")
            self.check(err <= bound and s_err <= s_bound,
                       f"ssd_scan {key} disagrees with plain")
            ms, eager_ms = self.timed(lambda: ops.ssd_chunked(
                x, dt, a, bm, cm, chunk=q), 20)
            plain_ms = self.time_ms(lambda: ref.ssd_scan(
                x.transpose(1, 2), dt.transpose(1, 2), a, bm, cm, chunk=q),
                3)
            el = 2 if dtype == torch.bfloat16 else 4
            # x, B, C, dt and a read once; y and the final state written
            nbytes = (2 * h * s * p + 2 * s * n) * el + h * s * 4 + h * 4 \
                + h * p * n * 4
            # the operations the function needs, chunk by chunk (the ragged
            # last one at its own length c): the causal C B^T, the same for
            # every head (ngroups = 1), c(c+1) N; per head the causal W x,
            # c(c+1) P, and C state^T and x^T B, 4 c N P
            flops = sum(c * (c + 1) * n + h * (c * (c + 1) * p + 4 * c * n * p)
                        for c in [q] * (s // q) + ([s % q] if s % q else []))
            t_bytes = nbytes / PEAK_BYTES_PER_S
            t_ops = flops / (PEAK_BF16_FLOPS if dtype == torch.bfloat16
                             else PEAK_F32_SPLIT_BF16_FLOPS)
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes > t_ops else "operations"
            if dtype == torch.float32:
                self.check(self.rehearse or min(ms, eager_ms) >= bound_ms,
                           f"ssd_scan {key}: a measured time under its "
                           f"bound")
            print(f"  ssd (1, {s}, {h}, {p}) N {n} chunk {q} {label}: kernel "
                  f"{ms:.4f} ms ({eager_ms:.4f} ms back to back), plain "
                  f"{plain_ms:.4f} ms, library n/a, bound "
                  f"{bound_ms:.5f} ms ({nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e9:.3f} GFLOP: bound by {bound_by})")
            self.rows[("ssd_scan", key)] = dict(
                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err, state_max_abs_err=s_err,
                library_ms=None, shape=f"1x{h}x{s}x{p}xN{n}/Q{q}")

    def mamba_vs_plain(self):
        """A 2-layer full-width mamba2 model, the kernel's run then the
        plain version's run, on the same params and tokens."""
        import numpy as np
        from repro_torch.kernels.ssd_scan import ref as ssd_ref
        from repro_torch.models import model as tmodel
        from repro_torch.models import ssm as ssm_mod
        cfg = self.llm_config(layers=2, arch="mamba2_1_3b")
        params = tmodel.init_params(cfg, 1, device=self.device)
        s, steps = (20, 4) if self.rehearse else (300, 4)
        rng = np.random.default_rng(2)
        prompt = rng.integers(0, cfg.vocab_size, (2, s))
        feed = rng.integers(0, cfg.vocab_size, (steps, 2))

        def run():
            logits, caches = tmodel.forward_prefill(cfg, params, prompt,
                                                    device=self.device)
            out = [logits]
            for tok in feed:
                logits, caches = tmodel.forward_decode(
                    cfg, params, caches, tok, s, device=self.device)
                out.append(logits)
            self.sync()
            return out

        def plain_chunked(x, dt, a, b_mat, c_mat, *, chunk, init_state=None):
            y, state = ssd_ref.ssd_scan(x.transpose(1, 2), dt.transpose(1, 2),
                                        a, b_mat, c_mat, chunk=chunk,
                                        init_state=init_state)
            return y.transpose(1, 2), state

        counters = wrappers()
        reset_counts(counters)
        kern = run()
        kern_launches = {n: fn.launches for n, fn in counters.items()}
        with mock.patch.object(ssm_mod, "ssd_chunked", plain_chunked):
            plain = run()
        plain_launches = {n: fn.launches for n, fn in counters.items()}
        print(f"  2-layer {cfg.name} {cfg.dtype}, prompt 2 x {s}, {steps} "
              f"decode steps: launches with the kernel {kern_launches}")
        self.paths["serving_mamba2_vs_plain"] = dict(
            max_abs_err=self.compare_logits(cfg, kern, plain, argmax=True))
        if not self.rehearse:
            self.check(kern_launches == dict(
                self.serving_launches(cfg, 1, steps), psdsf_fill=0,
                psdsf_fill_bucketed=0, psdsf_vds=0),
                f"kernel launches {kern_launches}")
            self.check(plain_launches == kern_launches,
                       "the plain run launched a kernel")

    # -- the MoE layer and the MoE models' serving paths ---------------------
    def moe_layer(self, arch="granite_moe_3b_a800m"):
        """The MoE layer alone at ``arch``'s widths in float32: the gather
        routing (the config's) against the dense GShard baseline on the
        same params and tokens, a prefill-sized call (1 x 1,024 tokens:
        groups of 256) and a decode-sized one (8 slots, five of them free:
        the same token-0 row). Both must route the same experts and keep
        the same slots (nonzero buffer rows), and their outputs agree to
        1e-4 x max(1, max|y|); both timed back to back."""
        torch = self.torch
        from repro_torch.models import moe as moe_mod
        cfg = dataclasses.replace(self.llm_config(arch=arch),
                                  dtype="float32", param_dtype="float32")
        gen = torch.Generator(device=self.device).manual_seed(5)
        layer = moe_mod.MoE(cfg, gen, torch.float32, self.device)
        route, ffn = moe_mod._route_torch, moe_mod._expert_ffn_torch
        seen = []

        def route_rec(*a, **k):
            out = route(*a, **k)
            seen.append(("idx", out[1]))
            return out

        def ffn_rec(cfg_, p, xin):
            seen.append(("kept", int((xin != 0).any(dim=-1).sum())))
            return ffn(cfg_, p, xin)
        table = {}
        shapes = ((1, 64), (8, 1)) if self.rehearse else ((1, 1024), (8, 1))
        for shape in shapes:
            x = torch.randn(shape + (cfg.d_model,), generator=gen,
                            device=self.device)
            if shape == (8, 1):
                x[3:] = x[3]
            outs = {}
            with mock.patch.object(moe_mod, "_route_torch", route_rec), \
                    mock.patch.object(moe_mod, "_expert_ffn_torch", ffn_rec):
                for impl, fn in (("gather", moe_mod.moe_apply_gather_torch),
                                 ("dense", moe_mod.moe_apply_dense_torch)):
                    seen.clear()
                    y, aux = fn(cfg, layer, x)
                    outs[impl] = (y, aux, dict(seen))
            (yg, ag, sg), (yd, ad, sd) = outs["gather"], outs["dense"]
            gsz, g, cap = moe_mod.moe_group_plan_torch(cfg, shape[0]
                                                       * shape[1])
            err = float((yg - yd).abs().max())
            bound = 1e-4 * max(1.0, float(yd.abs().max()))
            ms = {impl: self.time_ms(lambda f=fn: f(cfg, layer, x), 10)
                  for impl, fn in (("gather", moe_mod.moe_apply_gather_torch),
                                   ("dense", moe_mod.moe_apply_dense_torch))}
            print(f"  {cfg.name} MoE {shape[0]}x{shape[1]} tokens (groups "
                  f"{g} x {gsz}, cap {cap}): kept slots gather "
                  f"{sg['kept']}, dense {sd['kept']} of "
                  f"{shape[0] * shape[1] * cfg.moe_top_k} entries; "
                  f"max|gather-dense|={err:.3e} (bound {bound:.3e}), aux "
                  f"{float(ag):.6f} / {float(ad):.6f}; gather {ms['gather']:.3f}"
                  f" ms, dense {ms['dense']:.3f} ms (back to back)")
            self.check(torch.equal(sg["idx"], sd["idx"]),
                       "gather and dense routed differently")
            self.check(sg["kept"] == sd["kept"],
                       "gather and dense kept different slots")
            self.check(err <= bound and abs(float(ag) - float(ad)) <= 1e-6,
                       "gather and dense MoE disagree")
            table[f"{shape[0]}x{shape[1]}"] = dict(
                groups=g, group=gsz, cap=cap, kept=sg["kept"],
                max_abs_err=err, gather_ms=ms["gather"],
                dense_ms=ms["dense"])
        self.paths["moe_layer"] = table

    def moe_vs_plain(self, arch, layers):
        """A ``layers``-deep full-width ``arch``: the kernels' run, then the
        plain versions' run on the same params and tokens, its routing
        forced to the experts the kernels' run chose (a bfloat16 ulp in an
        attention or SSD output can move a router's k-th and (k+1)-th
        probabilities past each other). Rule (``TIE_REL``): every token
        whose own plain top-k set differs from the forced one is a near
        tie, its k-th and (k+1)-th plain probabilities within 2^-4 of the
        k-th, and such tokens are at most 2^-4 of those routed; the logits
        are then held to 2^-5 x max|logit|. Prints how far the two runs'
        router probabilities part (per token, the largest difference over
        the experts, relative to the k-th). Reuses the last serving
        phase's params where that model has this depth."""
        import numpy as np
        torch = self.torch
        from repro_torch.kernels.decode_attention import ref as decode_ref
        from repro_torch.kernels.flash_attention import ref as flash_ref
        from repro_torch.kernels.ssd_scan import ref as ssd_ref
        from repro_torch.models import attention as attention_mod
        from repro_torch.models import model as tmodel
        from repro_torch.models import moe as moe_mod
        from repro_torch.models import ssm as ssm_mod
        cfg = self.llm_config(layers, arch=arch)
        if getattr(self, "cfg_full", None) == cfg:
            params = self.params_full
        else:
            self.free_full_model()
            params = tmodel.init_params(cfg, 1, device=self.device)
        s, max_len, steps = (20, 32, 4) if self.rehearse else (300, 512, 4)
        rng = np.random.default_rng(2)
        prompt = rng.integers(0, cfg.vocab_size, (2, s))
        feed = rng.integers(0, cfg.vocab_size, (steps, 2))

        def run():
            logits, caches = tmodel.forward_prefill(cfg, params, prompt,
                                                    device=self.device)
            pool = tmodel.init_caches(cfg, 2, max_len, device=self.device)
            for i, one in enumerate(caches):
                if "k" in one:
                    for key in ("k", "v"):
                        pool[i][key][:, :s] = one[key]
                else:
                    pool[i] = one
            out = [logits]
            pos = torch.tensor([s, s + 7], dtype=torch.int32,
                               device=self.device)
            for tok in feed:
                logits, pool = tmodel.forward_decode(
                    cfg, params, pool, tok, pos, device=self.device)
                out.append(logits)
                pos += 1
            self.sync()
            return out

        def plain_chunked(x, dt, a, b_mat, c_mat, *, chunk, init_state=None):
            y, state = ssd_ref.ssd_scan(x.transpose(1, 2), dt.transpose(1, 2),
                                        a, b_mat, c_mat, chunk=chunk,
                                        init_state=init_state)
            return y.transpose(1, 2), state

        route = moe_mod._route_torch
        chosen, kern_probs, parts = [], [], []
        ties = dict(tokens=0, moved=0, max_gap=0.0)

        def route_rec(cfg_, p, xt, expert_idx=None):
            out = route(cfg_, p, xt)
            chosen.append(out[1])
            kern_probs.append(torch.softmax(xt.float() @ p.router, dim=-1))
            return out

        def route_forced(cfg_, p, xt, expert_idx=None):
            forced = chosen[ties["calls"]]
            ties["calls"] += 1
            k = cfg_.moe_top_k
            probs = torch.softmax(xt.float() @ p.router, dim=-1)
            top, own = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
            moved = (own[..., :k].sort(dim=-1).values
                     != forced.sort(dim=-1).values).any(dim=-1)
            gap = (top[..., k - 1] - top[..., k]) / top[..., k - 1]
            parts.append(((probs - kern_probs[ties["calls"] - 1]).abs()
                          .amax(dim=-1) / top[..., k - 1]).flatten())
            ties["tokens"] += moved.numel()
            ties["moved"] += int(moved.sum())
            if bool(moved.any()):
                ties["max_gap"] = max(ties["max_gap"],
                                      float(gap[moved].max()))
            return route(cfg_, p, xt, expert_idx=forced)

        def plain_decode(q, kc, vc, n, kv_start=None):
            return decode_ref.decode_attention(q[:, 0], kc, vc, n,
                                               kv_start=kv_start)[:, None]

        counters = wrappers()
        reset_counts(counters)
        with mock.patch.object(moe_mod, "_route_torch", route_rec):
            kern = run()
        kern_launches = {n: fn.launches for n, fn in counters.items()}
        ties["calls"] = 0
        with mock.patch.object(attention_mod, "flash_attention",
                               flash_ref.flash_attention), \
                mock.patch.object(attention_mod, "decode_attention",
                                  plain_decode), \
                mock.patch.object(ssm_mod, "ssd_chunked", plain_chunked), \
                mock.patch.object(moe_mod, "_route_torch", route_forced):
            plain = run()
        plain_launches = {n: fn.launches for n, fn in counters.items()}
        part = torch.cat(parts).float()
        spread = dict(median=float(part.median()),
                      p99=float(part.quantile(0.99)), max=float(part.max()))
        print(f"  {layers}-layer {cfg.name} {cfg.dtype}, prompt 2 x {s}, "
              f"{steps} decode steps: launches with the kernels "
              f"{kern_launches}; {len(chosen)} MoE calls, {ties['tokens']} "
              f"routed tokens; the runs' router probabilities part by a "
              f"median {spread['median']:.3e}, p99 {spread['p99']:.3e}, max "
              f"{spread['max']:.3e} of the k-th; {ties['moved']} tokens "
              f"whose own plain top-{cfg.moe_top_k} differs, largest k-th "
              f"vs (k+1)-th gap among them {ties['max_gap']:.3e} of the "
              f"k-th (rule: each <= 2^-4, and at most 2^-4 of the tokens)")
        self.check(ties["calls"] == len(chosen),
                   "the plain run made another number of MoE calls")
        self.check(ties["max_gap"] <= TIE_REL
                   and ties["moved"] <= TIE_REL * ties["tokens"],
                   "routing moved beyond near ties")
        self.paths[f"serving_{arch}_vs_plain"] = dict(
            layers=layers, max_abs_err=self.compare_logits(cfg, kern, plain),
            moe_calls=len(chosen), routed_tokens=ties["tokens"],
            moved_tokens=ties["moved"], max_moved_gap=ties["max_gap"],
            prob_spread=spread)
        if not self.rehearse:
            want = self.serving_launches(cfg, 1, steps)
            self.check(all(kern_launches[name] == count
                           for name, count in want.items()),
                       f"kernel launches {kern_launches}, expected {want}")
            self.check(plain_launches == kern_launches,
                       "the plain run launched a kernel")

    # -- the training step ----------------------------------------------------
    def flash_lse_vs_plain(self):
        """The flash kernel with ``return_lse=True`` against its plain
        version at qwen3_1_7b's and gemma_2b's widths, S 2,048, bfloat16
        and float32; then the lse call and the serving call (no lse) at
        qwen3's S 1,024 timed in turns (serving, lse, lse, serving)."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.flash_attention import kernel, ref
        s = 128 if self.rehearse else 2048
        for arch in ("qwen3_1_7b", "gemma_2b"):
            cfg = self.llm_config(arch=arch)
            hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            for label, dtype in (("bfloat16", torch.bfloat16),
                                 ("float32", torch.float32)):
                q, k, v = self.attn_inputs([(1, s, hq, d), (1, s, hkv, d),
                                            (1, s, hkv, d)], dtype, seed=s)
                before = {a: getattr(kernel.flash_attention, a)
                          for a in BODY_COUNTS}
                out, lse = kernel.flash_attention(q, k, v, return_lse=True)
                plain_out, plain_lse = ref.flash_attention(
                    q.float(), k.float(), v.float(), return_lse=True)
                self.sync()
                after = {a: getattr(kernel.flash_attention, a) - n
                         for a, n in before.items()}
                body = self.flash_body_of(label, d)[:-9]
                if not self.rehearse:
                    self.check(after[f"{body}_launches"] == 1
                               and after["lse_launches"] == 1,
                               f"flash lse {arch} {label}: launches "
                               f"{after}, expected the {body} body")
                rel = ATTN_REL if label == "bfloat16" else ATTN_F32_REL
                err = float((out.float() - plain_out).abs().max())
                bound = rel * max(1.0, float(plain_out.abs().max()))
                lse_err = float((lse - plain_lse).abs().max())
                print(f"  flash lse (1, {s}, {hq}/{hkv}, {d}) {label}, "
                      f"{body} body: out max|kernel-plain f32|={err:.3e} "
                      f"(bound {bound:.3e}), lse {lse_err:.3e} (bound "
                      f"{LSE_ATOL[label]:.0e}; lse in "
                      f"[{float(plain_lse.min()):.3f}, "
                      f"{float(plain_lse.max()):.3f}])")
                self.check(err <= bound and lse_err <= LSE_ATOL[label],
                           f"flash lse {arch} {label} disagrees with plain")
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

                def sdpa():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True)

                def lse_call():
                    return kernel.flash_attention(q, k, v, return_lse=True)
                ks, ls = self.interleaved(lse_call, sdpa, 10)
                ks2, cs, extra = [], [], {}
                if body == "tf32":
                    # held against the same plain and timed in turns with
                    # the CUDA-core body it replaced
                    cuda_core, cc_err = self.flash_cuda_core(
                        lse_call, plain_out, f"flash lse {arch} {label}",
                        plain_lse)
                    ks2, cs = self.interleaved(lse_call, cuda_core, 10)
                    extra = dict(cuda_core_ms=sum(cs) / 2,
                                 cuda_core_turns_ms=cs,
                                 cuda_core_max_abs_err=cc_err)
                plain_ms = self.time_ms(lambda: ref.flash_attention(
                    q, k, v, return_lse=True), 3)
                el = 2 if dtype == torch.bfloat16 else 4
                nbytes = (2 * hq + 2 * hkv) * s * d * el + hq * s * 4
                flops = 4 * hq * d * s * (s + 1) // 2
                t_bytes = nbytes / PEAK_BYTES_PER_S
                t_ops = flops / (PEAK_BF16_FLOPS if dtype == torch.bfloat16
                                 else PEAK_F32_TC_FLOPS)
                bound_ms = max(t_bytes, t_ops) * 1e3
                bound_by = "bytes" if t_bytes > t_ops else "operations"
                print(f"    kernel {ks[0]:.4f}, {ks[1]:.4f} ms, SDPA (out "
                      f"only) {ls[0]:.4f}, {ls[1]:.4f} ms"
                      + (f"; kernel {ks2[0]:.4f}, {ks2[1]:.4f} ms, CUDA-core "
                         f"body {cs[0]:.4f}, {cs[1]:.4f} ms" if cs else "")
                      + f"; plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
                      f"(bound by {bound_by})")
                if dtype == torch.float32:
                    self.check(self.rehearse or min(ks + ks2) >= bound_ms,
                               f"flash lse {arch} {label}: a measured time "
                               f"under its bound")
                key = self.row_key(f"{label}_lse", arch)
                self.rows[("flash_attention", key)] = dict(
                    ms=sum(ks) / 2, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, max_abs_err=err,
                    lse_max_abs_err=lse_err, library_ms=sum(ls) / 2,
                    library_computes="out only (SDPA returns no lse)",
                    turns_ms=ks + ks2, library_turns_ms=ls, body=body,
                    shape=f"1x{s}x{hq}/{hkv}x{d}", **extra)
        # the serving launch (lse null) against the lse launch, in turns
        cfg = self.llm_config()
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        s = 128 if self.rehearse else 1024
        q, k, v = self.attn_inputs([(1, s, hq, d), (1, s, hkv, d),
                                    (1, s, hkv, d)], torch.bfloat16, seed=s)
        serve_ms, lse_ms = self.interleaved(
            lambda: kernel.flash_attention(q, k, v),
            lambda: kernel.flash_attention(q, k, v, return_lse=True), 20)
        print(f"  flash (1, {s}, {hq}/{hkv}, {d}) bf16, serving call and lse "
              f"call in turns: serving {serve_ms[0]:.4f}, {serve_ms[1]:.4f} "
              f"ms; lse {lse_ms[0]:.4f}, {lse_ms[1]:.4f} ms")
        self.paths["flash_lse_turns"] = dict(
            shape=f"1x{s}x{hq}/{hkv}x{d}", serving_turns_ms=serve_ms,
            lse_turns_ms=lse_ms)

    # -- sliding window and float8 caches ------------------------------------
    def window_opts(self):
        """The windowed serving phase's config fields: ``WINDOW_SERVING``;
        in a rehearsal a window of 16, which the smoke prompts (8-40
        tokens) cross."""
        return dict(WINDOW_SERVING, **({"sliding_window": 16}
                                       if self.rehearse else {}))

    def flash_window_vs_plain(self):
        """The flash kernel with a sliding window against its plain
        version: on the Hopper body (bfloat16) qwen3_1_7b's 16/8 x 128 at S
        1,024, W 256, Mistral-7B-v0.1's 32/8 x 128 at S 8,192 with its W
        4,096 and gemma_2b's 8/1 x 256 at S 1,024, W 256; on the CUDA-core
        body qwen3's widths in float32, S 1,024, W 256; the lse call at
        qwen3's S 2,048, W 256. Each call must take its body and count as
        windowed. Each is timed in turns with SDPA given the same boolean
        window mask, and in turns with the kernel without the window
        (causal), beside the bound over the windowed pairs."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.flash_attention import kernel, ref
        self.free_full_model()
        qwen = self.llm_config()
        gemma = self.llm_config(arch="gemma_2b")
        widths = (qwen.num_heads, qwen.num_kv_heads, qwen.head_dim)
        if self.rehearse:
            s1, w1, s_lse, mistral, s_long, w_long = 128, 32, 128, widths, \
                256, 64
        else:
            s1, w1, s_lse = 1024, 256, 2048
            *mistral, w_long, s_long = MISTRAL_ATTN
        bf16, f32 = torch.bfloat16, torch.float32
        cases = (("bfloat16_window", widths, s1, w1, bf16, False),
                 ("bfloat16_window@mistral_7b_v0_1", tuple(mistral), s_long,
                  w_long, bf16, False),
                 ("bfloat16_window@gemma_2b", (gemma.num_heads,
                                               gemma.num_kv_heads,
                                               gemma.head_dim), s1, w1, bf16,
                  False),
                 ("float32_window", widths, s1, w1, f32, False),
                 ("bfloat16_window_lse", widths, s_lse, w1, bf16, True))
        fa = kernel.flash_attention
        for key, (hq, hkv, d), s, w, dtype, lse in cases:
            label = "bfloat16" if dtype == bf16 else "float32"
            q, k, v = self.attn_inputs([(1, s, hq, d), (1, s, hkv, d),
                                        (1, s, hkv, d)], dtype, seed=s + w)
            body = self.flash_body_of(label, d)
            before = (getattr(fa, body), fa.window_launches, fa.lse_launches)
            got = fa(q, k, v, window=w, return_lse=lse)
            plain = ref.flash_attention(q.float(), k.float(), v.float(),
                                        window=w, return_lse=lse)
            self.sync()
            after = (getattr(fa, body), fa.window_launches, fa.lse_launches)
            if not self.rehearse:
                self.check(after == (before[0] + 1, before[1] + 1,
                                     before[2] + lse),
                           f"flash window {key}: counts {before} -> "
                           f"{after}, expected the {body[:-9]} body, "
                           f"windowed")
            out, plain_out = (got[0], plain[0]) if lse else (got, plain)
            rel = ATTN_REL if dtype == bf16 else ATTN_F32_REL
            err = float((out.float() - plain_out).abs().max())
            bound = rel * max(1.0, float(plain_out.abs().max()))
            lse_err = float((got[1] - plain[1]).abs().max()) if lse else None
            del plain, plain_out
            print(f"  flash window (1, {s}, {hq}/{hkv}, {d}) {label}, W {w}, "
                  f"{body[:-9]} body{', lse' if lse else ''}: "
                  f"max|kernel-plain f32|={err:.3e} (bound {bound:.3e})"
                  + (f", lse {lse_err:.3e} (bound {LSE_ATOL[label]:.0e})"
                     if lse else ""))
            self.check(err <= bound and (not lse
                                         or lse_err <= LSE_ATOL[label]),
                       f"flash window {key} disagrees with plain")
            mask = torch.ones((s, s), dtype=torch.bool,
                              device=self.device).tril().triu(1 - w)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)

            def windowed():
                return fa(q, k, v, window=w, return_lse=lse)

            def causal():
                return fa(q, k, v, return_lse=lse)
            iters = 5 if s > 4096 else 20
            ks, ls = self.interleaved(windowed, sdpa, iters)
            ks2, cs = self.interleaved(windowed, causal, iters)
            plain_ms = self.time_ms(lambda: ref.flash_attention(
                q, k, v, window=w, return_lse=lse), 2)
            el = 2 if dtype == bf16 else 4
            nbytes = (2 * hq + 2 * hkv) * s * d * el + (hq * s * 4 if lse
                                                         else 0)
            pairs = kernel.attended_pairs_np(s, True, w)
            flops = 4 * hq * d * pairs
            t_bytes = nbytes / PEAK_BYTES_PER_S
            t_ops = flops / (PEAK_BF16_FLOPS if dtype == bf16
                             else PEAK_F32_TC_FLOPS)
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes > t_ops else "operations"
            if dtype == f32:
                self.check(self.rehearse or min(ks + ks2) >= bound_ms,
                           f"flash window {key}: a measured time under its "
                           f"bound")
            print(f"    in turns: windowed {ks[0]:.4f}, {ks[1]:.4f} ms, SDPA "
                  f"with the window mask {ls[0]:.4f}, {ls[1]:.4f} ms; "
                  f"windowed {ks2[0]:.4f}, {ks2[1]:.4f} ms, causal (no "
                  f"window) {cs[0]:.4f}, {cs[1]:.4f} ms; plain "
                  f"{plain_ms:.4f} ms; bound {bound_ms:.5f} ms ({pairs} "
                  f"pairs a head of {s * (s + 1) // 2} causal, "
                  f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP: bound "
                  f"by {bound_by})")
            self.rows[("flash_attention", key)] = dict(
                ms=sum(ks) / 2, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=err, library_ms=sum(ls) / 2,
                library_computes="SDPA with the boolean window mask",
                causal_ms=sum(cs) / 2, turns_ms=ks + ks2,
                library_turns_ms=ls, causal_turns_ms=cs, window=w,
                pairs=pairs, body=body[:-9], lse_max_abs_err=lse_err,
                shape=f"1x{s}x{hq}/{hkv}x{d}")

    def decode_fp8_vs_plain(self):
        """The decode kernel over float8 caches with and without first
        rows, against its plain version: 8 slots x 2,048 rows at
        qwen3_1_7b's 16/8 x 128 and qwen2_5_32b's 40/8 x 128 (groups of 5:
        the tensor-core body), e4m3 and e5m2 caches, without first rows and
        with first rows at 0, inside the length and equal to it; each split
        into 1, 2 and 4 chunks a sequence and into the wrapper's own; out
        and lse held to the plain version's on the same bytes, every call
        counted as float8 (and windowed). Timed at the wrapper's chunk in
        turns with the bfloat16-cache kernel on the same rows, and with
        SDPA on the bfloat16 cache with the rows masked, beside the byte
        bound at one byte a cached value."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.decode_attention import kernel, ref
        self.free_full_model()
        da = kernel.decode_attention
        for arch in ("qwen3_1_7b", "qwen2_5_32b"):
            cfg = self.llm_config(arch=arch)
            hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            b, s_max = (8, 64) if self.rehearse else (8, 2048)
            q, kc, vc = self.attn_inputs([(b, hq, d), (b, s_max, hkv, d),
                                          (b, s_max, hkv, d)],
                                         torch.bfloat16, seed=9)
            lens = [1, s_max, s_max + 37, s_max // 2 + 3, s_max // 4 + 1, 64,
                    3 * s_max // 4 - 5, s_max - 1]
            valid = [min(n, s_max) for n in lens]
            # first rows: 0, inside the length (past whole chunks at every
            # split), equal to it (no row)
            starts = [0, 0, valid[2] - 300, valid[3] // 2, valid[4] - 1, 37,
                      valid[6], valid[7] - 700]
            starts = [max(0, min(f, n)) for f, n in zip(starts, valid)]
            kv_len = torch.tensor(lens, dtype=torch.int32, device=self.device)
            first = torch.tensor(starts, dtype=torch.int32,
                                 device=self.device)
            for cache in FP8_CACHES:
                dt = getattr(torch, cache)
                k8, v8 = kc.to(dt), vc.to(dt)
                tag = cache.split("_")[1][:4]           # e4m3, e5m2
                for start in (None, first):
                    plain, plain_lse = ref.decode_attention(
                        q.float(), k8.float(), v8.float(), kv_len,
                        kv_start=start, return_lse=True)
                    worst, worst_lse = 0.0, 0.0
                    for n_chunks in (1, 2, 4, None):
                        chunk = (s_max // n_chunks if n_chunks
                                 else kernel.chunk_rows(b, s_max, hkv))
                        before = (da.launches, da.window_launches,
                                  da.fp8_launches)
                        with mock.patch.object(kernel, "chunk_rows",
                                               lambda *a, c=chunk: c):
                            got, lse = da(q, k8, v8, kv_len, kv_start=start,
                                          return_lse=True)
                        self.sync()
                        if not self.rehearse:
                            self.check(
                                (da.launches, da.window_launches,
                                 da.fp8_launches) == (
                                    before[0] + 1,
                                    before[1] + (start is not None),
                                    before[2] + 1),
                                f"decode {cache} launch counts")
                        worst = max(worst, float(
                            (got.float() - plain).abs().max()))
                        same_inf = torch.equal(torch.isinf(lse),
                                               torch.isinf(plain_lse))
                        self.check(same_inf, f"decode {cache}: the heads "
                                             f"with no row differ")
                        fin = torch.isfinite(plain_lse)
                        worst_lse = max(worst_lse, float(
                            (lse[fin] - plain_lse[fin]).abs().max()))
                    bound = ATTN_REL * max(1.0, float(plain.abs().max()))
                    what = (f"decode {b}x{s_max} {hq}/{hkv} x {d}, {cache}"
                            f"{', first rows' if start is not None else ''}")
                    print(f"  {what}, 1/2/4 chunks and the wrapper's: "
                          f"max|kernel-plain f32|={worst:.3e} (bound "
                          f"{bound:.3e}), lse {worst_lse:.3e} (bound "
                          f"{LSE_ATOL['bfloat16']:.0e})")
                    self.check(worst <= bound
                               and worst_lse <= LSE_ATOL["bfloat16"],
                               f"{what} disagrees with plain")
                    lo = start if start is not None else torch.zeros_like(
                        kv_len)
                    rows = torch.arange(s_max, device=self.device)[None, :]
                    mask = ((rows >= lo[:, None])
                            & (rows < kv_len.clamp(max=s_max)[:, None]))
                    mask = mask[:, None, None, :]
                    qt = q[:, :, None, :]
                    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)

                    def sdpa():
                        return F.scaled_dot_product_attention(
                            qt, kt, vt, attn_mask=mask, enable_gqa=True)

                    def fp8(s_=start):
                        return da(q, k8, v8, kv_len, kv_start=s_)

                    def bf16(s_=start):
                        return da(q, kc, vc, kv_len, kv_start=s_)
                    ks, ls = self.interleaved(fp8, sdpa, 50)
                    ks2, bs = self.interleaved(fp8, bf16, 50)
                    plain_ms = self.time_ms(lambda: ref.decode_attention(
                        q, k8, v8, kv_len, kv_start=start), 10)
                    n_rows = sum(max(0, n - (f if start is not None else 0))
                                 for f, n in zip(starts, valid))
                    nbytes = (2 * n_rows * hkv * d + 2 * b * hq * d * 2
                              + b * 4 * (1 + (start is not None)))
                    flops = 4 * n_rows * hq * d
                    bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                                   flops / PEAK_BF16_FLOPS) * 1e3
                    print(f"    in turns: {cache} {ks[0]:.4f}, {ks[1]:.4f} ms,"
                          f" SDPA (bf16 cache, rows masked) {ls[0]:.4f}, "
                          f"{ls[1]:.4f} ms; {cache} {ks2[0]:.4f}, "
                          f"{ks2[1]:.4f} ms, bf16 cache {bs[0]:.4f}, "
                          f"{bs[1]:.4f} ms; plain {plain_ms:.4f} ms; bound "
                          f"{bound_ms:.5f} ms ({n_rows} rows, "
                          f"{nbytes / 1e6:.2f} MB at one byte a cached "
                          f"value: bound by bytes)")
                    key = self.row_key(
                        tag + ("_window" if start is not None else ""), arch)
                    self.rows[("decode_attention", key)] = dict(
                        ms=sum(ks) / 2, plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by="bytes", max_abs_err=worst,
                        lse_max_abs_err=worst_lse, library_ms=sum(ls) / 2,
                        library_computes="SDPA on the bfloat16 cache",
                        bf16_cache_ms=sum(bs) / 2, turns_ms=ks + ks2,
                        library_turns_ms=ls, bf16_cache_turns_ms=bs,
                        rows=n_rows, cache=cache,
                        shape=f"{b}x{s_max}x{hq}/{hkv}x{d}")

    def train_step_window(self):
        """One ``build_train_step_torch`` step of full-width qwen3_1_7b
        with a sliding window of ``TRAIN_STEP_WINDOW`` (the training
        step's shapes: B 2 x S 2,048 in 2 microbatches, remat, flash blocks
        of 1,024), after a warm-up step: counts set to 0 before it, every
        flash launch on the Hopper body with lse and the window; prints
        its loss and wall."""
        window = 32 if self.rehearse else TRAIN_STEP_WINDOW
        cfg = dataclasses.replace(self.llm_config(), remat="full",
                                  attn_flash_block=16 if self.rehearse
                                  else 1024, sliding_window=window)
        b, s, micro = (2, 64, 2) if self.rehearse else (2, 2048, 2)
        first, metrics, wall, _, launches, flash = self.train_two_steps(
            cfg, micro, b, s)
        print(f"  {cfg.name}: {cfg.num_layers} layers, window {window}, B "
              f"{b} x S {s} in {micro} microbatches: step 2 "
              f"{wall * 1e3:.1f} ms ({b * s / wall:.0f} tokens/s), loss "
              f"{metrics['loss']:.5f}, grad_norm {metrics['grad_norm']:.5f} "
              f"(step 1 loss {first['loss']:.5f}); launches "
              f"{launches}; flash {flash}")
        self.paths["train_step_window"] = dict(
            launches=launches, flash=flash, wall_s=wall, window=window,
            tokens_per_s=b * s / wall, metrics=metrics,
            first_loss=first["loss"])
        if not self.rehearse:
            n_flash = cfg.num_layers * micro * 2
            want = dict.fromkeys(launches, 0)
            want["flash_attention"] = n_flash
            self.check(launches == want and flash == dict(
                hopper_launches=n_flash, tf32_launches=0,
                cuda_core_launches=0, lse_launches=n_flash,
                window_launches=n_flash),
                f"windowed training launches {launches}, flash {flash}")

    def decode_mixed_vs_plain(self):
        """The decode kernel's float32-query, bfloat16-cache entry (float32
        params over bfloat16 activations), with and without first rows,
        against its plain version: 8 slots x 2,048 rows at qwen3_1_7b's
        16/8 x 128 and qwen2_5_32b's 40/8 x 128 (groups of 5), each split
        into 1, 2 and 4 chunks a sequence and into the wrapper's own; out
        and lse held to the plain version's on the same bytes at the
        float32 entry's bounds, every call counted as mixed. Timed at the
        wrapper's chunk in turns with the float32 entry over the same cache
        widened to float32, with the bfloat16-cache kernel on a bfloat16 q
        and with SDPA on the float32 q over the widened cache, beside the
        byte bound (two bytes a cached value, four a q and output
        value)."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels.decode_attention import kernel, ref
        self.free_full_model()
        da = kernel.decode_attention
        for arch in ("qwen3_1_7b", "qwen2_5_32b"):
            cfg = self.llm_config(arch=arch)
            hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            b, s_max = (8, 64) if self.rehearse else (8, 2048)
            q, kc, vc = self.attn_inputs([(b, hq, d), (b, s_max, hkv, d),
                                          (b, s_max, hkv, d)],
                                         torch.bfloat16, seed=11)
            q32 = self.attn_inputs([(b, hq, d)], torch.float32, seed=12)[0]
            k32, v32 = kc.float(), vc.float()
            lens = [1, s_max, s_max + 37, s_max // 2 + 3, s_max // 4 + 1, 64,
                    3 * s_max // 4 - 5, s_max - 1]
            valid = [min(n, s_max) for n in lens]
            starts = [0, 0, valid[2] - 300, valid[3] // 2, valid[4] - 1, 37,
                      valid[6], valid[7] - 700]
            starts = [max(0, min(f, n)) for f, n in zip(starts, valid)]
            kv_len = torch.tensor(lens, dtype=torch.int32, device=self.device)
            first = torch.tensor(starts, dtype=torch.int32,
                                 device=self.device)
            for start in (None, first):
                plain, plain_lse = ref.decode_attention(
                    q32, kc, vc, kv_len, kv_start=start, return_lse=True)
                worst, worst_lse = 0.0, 0.0
                for n_chunks in (1, 2, 4, None):
                    chunk = (s_max // n_chunks if n_chunks
                             else kernel.chunk_rows(b, s_max, hkv))
                    before = (da.launches, da.mixed_launches,
                              da.fp8_launches)
                    with mock.patch.object(kernel, "chunk_rows",
                                           lambda *a, c=chunk: c):
                        got, lse = da(q32, kc, vc, kv_len, kv_start=start,
                                      return_lse=True)
                    self.sync()
                    if not self.rehearse:
                        self.check(
                            (da.launches, da.mixed_launches,
                             da.fp8_launches) == (
                                before[0] + 1, before[1] + 1, before[2]),
                            "decode float32/bfloat16 launch counts")
                    self.check(got.dtype == torch.float32,
                               f"the mixed entry's output is {got.dtype}")
                    worst = max(worst, float((got - plain).abs().max()))
                    self.check(torch.equal(torch.isinf(lse),
                                           torch.isinf(plain_lse)),
                               "decode float32/bfloat16: the heads with no "
                               "row differ")
                    fin = torch.isfinite(plain_lse)
                    worst_lse = max(worst_lse, float(
                        (lse[fin] - plain_lse[fin]).abs().max()))
                bound = ATTN_F32_REL * max(1.0, float(plain.abs().max()))
                what = (f"decode {b}x{s_max} {hq}/{hkv} x {d}, float32 q over "
                        f"a bfloat16 cache"
                        f"{', first rows' if start is not None else ''}")
                print(f"  {what}, 1/2/4 chunks and the wrapper's: "
                      f"max|kernel-plain|={worst:.3e} (bound {bound:.3e}), "
                      f"lse {worst_lse:.3e} (bound "
                      f"{LSE_ATOL['float32']:.0e})")
                self.check(worst <= bound and worst_lse <= LSE_ATOL["float32"],
                           f"{what} disagrees with plain")
                lo = start if start is not None else torch.zeros_like(kv_len)
                rows = torch.arange(s_max, device=self.device)[None, :]
                mask = ((rows >= lo[:, None])
                        & (rows < kv_len.clamp(max=s_max)[:, None]))
                mask = mask[:, None, None, :]
                qt = q32[:, :, None, :]
                kt, vt = k32.transpose(1, 2), v32.transpose(1, 2)

                def sdpa():
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, attn_mask=mask, enable_gqa=True)

                def mixed(s_=start):
                    return da(q32, kc, vc, kv_len, kv_start=s_)

                def f32(s_=start):
                    return da(q32, k32, v32, kv_len, kv_start=s_)

                def bf16(s_=start):
                    return da(q, kc, vc, kv_len, kv_start=s_)
                ks, ls = self.interleaved(mixed, sdpa, 50)
                ks2, fs = self.interleaved(mixed, f32, 50)
                ks3, bs = self.interleaved(mixed, bf16, 50)
                plain_ms = self.time_ms(lambda: ref.decode_attention(
                    q32, kc, vc, kv_len, kv_start=start), 10)
                n_rows = sum(max(0, n - (f if start is not None else 0))
                             for f, n in zip(starts, valid))
                nbytes = (2 * n_rows * hkv * d * 2 + 2 * b * hq * d * 4
                          + b * 4 * (1 + (start is not None)))
                flops = 4 * n_rows * hq * d
                bound_ms = max(nbytes / PEAK_BYTES_PER_S,
                               flops / PEAK_FLOPS["float32"]) * 1e3
                bound_by = ("bytes" if nbytes / PEAK_BYTES_PER_S
                            >= flops / PEAK_FLOPS["float32"]
                            else "operations")
                print(f"    in turns: mixed {ks[0]:.4f}, {ks[1]:.4f} ms, SDPA "
                      f"(float32 q and widened cache, rows masked) "
                      f"{ls[0]:.4f}, {ls[1]:.4f} ms; mixed {ks2[0]:.4f}, "
                      f"{ks2[1]:.4f} ms, float32 entry over the widened cache "
                      f"{fs[0]:.4f}, {fs[1]:.4f} ms; mixed {ks3[0]:.4f}, "
                      f"{ks3[1]:.4f} ms, bfloat16 q over the bfloat16 cache "
                      f"{bs[0]:.4f}, {bs[1]:.4f} ms; plain {plain_ms:.4f} ms;"
                      f" bound {bound_ms:.5f} ms ({n_rows} rows, "
                      f"{nbytes / 1e6:.2f} MB: bound by {bound_by})")
                self.check(self.rehearse or min(ks + ks2 + ks3) >= bound_ms,
                           f"{what}: a measured time under its bound")
                key = self.row_key(
                    "f32_bf16" + ("_window" if start is not None else ""),
                    arch)
                self.rows[("decode_attention", key)] = dict(
                    ms=sum(ks) / 2, plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by, max_abs_err=worst,
                    lse_max_abs_err=worst_lse, library_ms=sum(ls) / 2,
                    library_computes="SDPA on the float32 q over the cache "
                                     "widened to float32",
                    f32_entry_ms=sum(fs) / 2, bf16_cache_ms=sum(bs) / 2,
                    turns_ms=ks + ks2 + ks3, library_turns_ms=ls,
                    f32_entry_turns_ms=fs, bf16_cache_turns_ms=bs,
                    rows=n_rows, shape=f"{b}x{s_max}x{hq}/{hkv}x{d}")

    def train_two_steps(self, cfg, micro, b, s, seed=4):
        """Two ``build_train_step_torch`` steps of ``cfg`` (float32
        moments) from its seeded init: a warm-up step, then one with every
        count set to 0 and the peak device memory reset just before it;
        fails unless both steps' metrics are finite, grad_norm > 0 and the
        loss near ln V. Returns (step 1's metrics, step 2's, step 2's wall,
        its peak GiB, launches, flash launches by body, lse and
        window)."""
        import numpy as np
        torch = self.torch
        from repro_torch.models import model as tmodel
        from repro_torch.train import (OptimizerConfig,
                                       build_train_step_torch,
                                       make_train_state_torch)
        self.free_full_model()
        oc = OptimizerConfig()
        rng = np.random.default_rng(seed)
        batches = []
        for _ in range(2):
            tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                     device=self.device)
            batches.append({"tokens": tokens, "labels": tokens.roll(-1, 1)})
        state = make_train_state_torch(
            cfg, tmodel.init_params(cfg, 0, device=self.device), oc,
            device=self.device)
        step = build_train_step_torch(cfg, oc, micro, device=self.device)
        state, first = step(state, batches[0])
        first = {k: float(v) for k, v in first.items()}
        self.sync()
        counters = wrappers()
        reset_counts(counters)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[1])
        self.sync()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if self.device.type == "cuda" else None)
        launches = {n: fn.launches for n, fn in counters.items()}
        bodies = {a: getattr(counters["flash_attention"], a)
                  for a in BODY_COUNTS + ("window_launches",)}
        metrics = {k: float(v) for k, v in metrics.items()}
        del state
        self.free_full_model()
        ln_v = float(np.log(cfg.vocab_size))
        for m in (first, metrics):
            self.check(all(np.isfinite(v) for v in m.values())
                       and m["grad_norm"] > 0
                       and abs(m["loss"] - ln_v) < 1.0,
                       f"training metrics {m}: expected finite, grad_norm "
                       f"> 0, loss near ln V = {ln_v:.3f}")
        return first, metrics, wall, peak, launches, bodies

    def train_step_split(self):
        """One full-width qwen3_1_7b step with float32 params over bfloat16
        activations (``SPLIT_DTYPES``; the training step's shapes: B 2 x S
        2,048 in 2 microbatches, remat="full", flash blocks of 1,024,
        float32 moments), after a warm-up step: every flash launch on the
        float32 tensor-core body with lse; prints the wall, tokens/s and the
        peak device memory."""
        cfg = dataclasses.replace(self.llm_config(), remat="full",
                                  attn_flash_block=16 if self.rehearse
                                  else 1024, **SPLIT_DTYPES)
        b, s, micro = (2, 64, 2) if self.rehearse else (2, 2048, 2)
        first, metrics, wall, peak, launches, bodies = self.train_two_steps(
            cfg, micro, b, s)
        print(f"  {cfg.name}: {cfg.num_layers} layers, params "
              f"{cfg.param_dtype} over {cfg.dtype} activations, moments "
              f"float32; B {b} x S {s} in {micro} microbatches: step 2 "
              f"{wall * 1e3:.1f} ms ({b * s / wall:.0f} tokens/s), loss "
              f"{metrics['loss']:.5f}, grad_norm {metrics['grad_norm']:.5f} "
              f"(step 1 loss {first['loss']:.5f}); launches {launches}; "
              f"flash by body {bodies}"
              + (f"; peak device memory {peak:.2f} GiB" if peak else ""))
        self.paths["train_step_split"] = dict(
            launches=launches, flash_bodies=bodies, wall_s=wall,
            tokens_per_s=b * s / wall, peak_gib=peak, metrics=metrics,
            first=first, microbatches=micro)
        if not self.rehearse:
            n_flash = cfg.num_layers * micro * 2
            want = dict.fromkeys(launches, 0)
            want["flash_attention"] = n_flash
            self.check(launches == want and bodies == {
                "hopper_launches": 0, "tf32_launches": n_flash,
                "cuda_core_launches": 0, "lse_launches": n_flash,
                "window_launches": 0},
                f"split training launches {launches}, flash {bodies}: "
                f"expected every launch on the float32 tensor-core body")

    def train_step_remat(self):
        """The bfloat16 full-width qwen3_1_7b step (the training step's
        shapes) under remat "full", "dots" and "none" in turn, each from
        the same seeded params and batches: step 2's wall and peak device
        memory under each; fails unless the peaks are ordered full <= dots
        <= none and step 1's losses (the same params and batch) agree
        within the bfloat16 step's bound."""
        base = dataclasses.replace(self.llm_config(),
                                   attn_flash_block=16 if self.rehearse
                                   else 1024)
        b, s, micro = (2, 64, 2) if self.rehearse else (2, 2048, 2)
        runs = {}
        for remat in REMATS:
            cfg = dataclasses.replace(base, remat=remat)
            first, metrics, wall, peak, launches, _ = self.train_two_steps(
                cfg, micro, b, s)
            runs[remat] = dict(first_loss=first["loss"],
                               loss=metrics["loss"], wall_s=wall,
                               tokens_per_s=b * s / wall, peak_gib=peak,
                               launches=launches)
            print(f"  remat {remat}: step 2 {wall * 1e3:.1f} ms "
                  f"({b * s / wall:.0f} tokens/s), loss "
                  f"{metrics['loss']:.5f} (step 1 {first['loss']:.5f}); "
                  f"flash launches {launches['flash_attention']}"
                  + (f"; peak device memory {peak:.2f} GiB" if peak
                     else ""))
            if not self.rehearse:
                recompute = 2 if remat != "none" else 1
                self.check(launches["flash_attention"]
                           == cfg.num_layers * micro * recompute,
                           f"remat {remat}: flash launched "
                           f"{launches['flash_attention']} times")
        ref_loss = runs["full"]["first_loss"]
        gaps = {r: abs(v["first_loss"] - ref_loss) / abs(ref_loss)
                for r, v in runs.items()}
        print(f"  step 1 loss gaps to remat full: "
              + ", ".join(f"{r} {g:.2e}" for r, g in gaps.items())
              + f" (bound {TRAIN_BF16_LOSS_REL:.2e})")
        self.paths["train_step_remat"] = dict(runs=runs, loss_rel_gaps=gaps)
        self.check(all(g <= TRAIN_BF16_LOSS_REL for g in gaps.values()),
                   "the remat policies' losses disagree")
        if not self.rehearse:
            peaks = [runs[r]["peak_gib"] for r in REMATS]
            self.check(peaks == sorted(peaks),
                       f"peaks {dict(zip(REMATS, peaks))} not ordered full "
                       f"<= dots <= none")

    def train_grads(self, cfg, params, batch):
        """(loss, {name: gradient}) of one forward and backward."""
        from repro_torch.models.model import forward_train_torch
        for p in params.parameters():
            p.grad = None
        loss, _ = forward_train_torch(cfg, params, batch, device=self.device)
        loss.backward()
        self.sync()
        grads = {n: p.grad for n, p in params.named_parameters()}
        for p in params.parameters():
            p.grad = None
        return float(loss.detach()), grads

    def train_vs_plain(self, arch, window=0, dtypes=None):
        """A 2-layer full-width ``arch`` in float32 (or with the params'
        and activations' dtypes ``dtypes`` sets: float32 params over
        bfloat16 activations keep every gradient float32), B 2 x S 2,048
        (with a sliding window of ``window`` where given): the training
        forward and backward with the kernels, then with the plain versions
        (flash's and ssd_scan's, patched where the model calls them); the
        loss and every gradient held to 1e-4 x max|.|, each kernel launched
        twice a layer (the recompute)."""
        import numpy as np
        from repro_torch.kernels.flash_attention import ref as flash_ref
        from repro_torch.kernels.ssd_scan import ref as ssd_ref
        from repro_torch.models import attention as attention_mod
        from repro_torch.models import model as tmodel
        from repro_torch.models import ssm as ssm_mod
        self.free_full_model()
        cfg = dataclasses.replace(self.llm_config(layers=2, arch=arch),
                                  **(dtypes or dict(dtype="float32",
                                                    param_dtype="float32")),
                                  sliding_window=window)
        b, s = (2, 64) if self.rehearse else (2, 2048)
        if self.rehearse:
            cfg = dataclasses.replace(cfg, attn_flash_block=16)
        params = tmodel.init_params(cfg, 5, device=self.device)
        params.requires_grad_(True)
        rng = np.random.default_rng(3)
        tokens = rng.integers(0, cfg.vocab_size, (b, s))
        batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}

        def plain_ssd(x, dt, a, b_mat, c_mat, *, chunk):
            y, _ = ssd_ref.ssd_scan(x.transpose(1, 2), dt.transpose(1, 2),
                                    a, b_mat, c_mat, chunk=chunk)
            return y.transpose(1, 2)
        counters = wrappers()
        reset_counts(counters)
        t0 = time.perf_counter()
        loss, grads = self.train_grads(cfg, params, batch)
        kern_s = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        lse = counters["flash_attention"].lse_launches
        windowed = counters["flash_attention"].window_launches
        body = self.flash_body(cfg)
        on_body = getattr(counters["flash_attention"], body)
        with mock.patch.object(attention_mod, "flash_attention",
                               flash_ref.flash_attention), \
                mock.patch.object(ssm_mod, "ssd_chunked_train", plain_ssd):
            t0 = time.perf_counter()
            want_loss, want = self.train_grads(cfg, params, batch)
            plain_s = time.perf_counter() - t0
        plain_launches = {n: fn.launches for n, fn in counters.items()}
        # with float32 params over bfloat16 activations, the gradients
        # that pass through a bfloat16 activation's cotangent (the
        # embedding's, layer 0's mixer norm's) carry its roundings: held to
        # two bfloat16 roundings of their largest value, the rest to 1e-4
        split = cfg.param_dtype == "float32" and cfg.dtype == "bfloat16"
        rounded = {n for n in want if split and n in SPLIT_BF16_PATH}
        worst, worst_name, worst_rounded = 0.0, None, 0.0
        for name, w in want.items():
            err = float((grads[name].float() - w.float()).abs().max())
            ratio = err / max(float(w.abs().max()), 1e-30)
            if name in rounded:
                worst_rounded = max(worst_rounded, ratio)
            elif ratio >= worst:
                worst, worst_name = ratio, name
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        print(f"  2-layer {cfg.name} params {cfg.param_dtype}, "
              f"activations {cfg.dtype}, B {b} x S {s}, window "
              f"{window}, flash blocks {cfg.attn_flash_block}: loss kernels "
              f"{loss:.6f}, plain {want_loss:.6f} (rel {loss_rel:.2e}); "
              f"worst gradient |kernels-plain| / max|plain| {worst:.2e} "
              f"({worst_name}) over {len(want)} tensors (bound "
              f"{TRAIN_F32_REL:.0e})"
              + (f", through bfloat16 cotangents "
                 f"({', '.join(sorted(rounded))}) {worst_rounded:.2e} "
                 f"(bound {SPLIT_ROUNDED_REL:.2e})" if rounded else "")
              + f"; forward+backward {kern_s:.3f} s with "
              f"kernels, {plain_s:.3f} s plain; launches {launches}, "
              f"flash with lse {lse}, windowed {windowed}, on the "
              f"{body[:-9]} body {on_body}")
        self.paths[f"train_{arch}_vs_plain"
                   + (f"_window{window}" if window else "")
                   + ("_split" if dtypes else "")] = dict(
            loss=loss, plain_loss=want_loss, loss_rel=loss_rel,
            grad_worst_rel=worst, grad_worst=worst_name,
            grad_rounded_worst_rel=worst_rounded, launches=launches,
            lse_launches=lse, window_launches=windowed, window=window,
            wall_s=kern_s, plain_wall_s=plain_s)
        self.check(np.isfinite(loss) and loss_rel <= TRAIN_F32_REL
                   and worst <= TRAIN_F32_REL
                   and worst_rounded <= SPLIT_ROUNDED_REL,
                   f"{arch} training gradients with the kernels disagree "
                   f"with the plain versions'")
        if not self.rehearse:
            want_launches = {n: 0 for n in counters}
            pattern = cfg.block_pattern
            kinds = [pattern[i % len(pattern)][0]
                     for i in range(cfg.num_layers)]
            want_launches["flash_attention"] = 2 * kinds.count("attn")
            want_launches["ssd_scan"] = 2 * kinds.count("mamba")
            n_flash = want_launches["flash_attention"]
            self.check(launches == want_launches and lse == n_flash
                       and on_body == n_flash
                       and windowed == (n_flash if window else 0),
                       f"training launches {launches} (lse {lse}, "
                       f"windowed {windowed}, {body} {on_body}), expected "
                       f"{want_launches}, every flash launch on the "
                       f"{body[:-9]} body")
            self.check(plain_launches == launches,
                       "the plain run launched a kernel")

    def train_step(self):
        """One ``build_train_step_torch`` step of full-width qwen3_1_7b
        (bfloat16 params, float32 moments, B 2 x S 2,048 in 2
        microbatches, remat="full", flash blocks of 1,024 rows): a warm-up
        step, the step driven with every count set to 0, one profiled
        step; then the first step again from the same seeded params with
        the plain flash."""
        import numpy as np
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile, record_function
        from repro_torch.kernels.flash_attention import ref as flash_ref
        from repro_torch.models import attention as attention_mod
        from repro_torch.models import model as tmodel
        from repro_torch.train import step as step_mod
        from repro_torch.train import (OptimizerConfig,
                                       build_train_step_torch,
                                       make_train_state_torch)
        self.free_full_model()
        cfg = dataclasses.replace(self.llm_config(), remat="full",
                                  attn_flash_block=16 if self.rehearse
                                  else 1024)
        b, s, micro = (2, 64, 2) if self.rehearse else (2, 2048, 2)
        oc = OptimizerConfig()
        rng = np.random.default_rng(4)
        batches = []
        for _ in range(3):
            tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                     device=self.device)
            batches.append({"tokens": tokens,
                            "labels": tokens.roll(-1, 1)})

        def fresh_state():
            params = tmodel.init_params(cfg, 0, device=self.device)
            return make_train_state_torch(cfg, params, oc,
                                          device=self.device)
        step = build_train_step_torch(cfg, oc, micro, device=self.device)
        state = fresh_state()
        n_params = sum(p.numel() for p in state["params"].parameters())
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        self.sync()
        t0 = time.perf_counter()
        state, first = step(state, batches[0])
        self.sync()
        first_s = time.perf_counter() - t0
        first = {k: float(v) for k, v in first.items()}
        counters = wrappers()
        reset_counts(counters)
        self.sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batches[1])
        self.sync()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        bodies = {a: getattr(counters["flash_attention"], a)
                  for a in BODY_COUNTS}
        metrics = {k: float(v) for k, v in metrics.items()}
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if self.device.type == "cuda" else None)
        tokens_per_s = b * s / wall
        print(f"  {cfg.name}: {cfg.num_layers} layers, {n_params} params "
              f"{cfg.param_dtype}, moments {oc.state_dtype}; B {b} x S {s} "
              f"in {micro} microbatches, remat {cfg.remat}, flash blocks "
              f"{cfg.attn_flash_block}")
        print(f"  step 1 (warm-up) {first_s * 1e3:.1f} ms: loss "
              f"{first['loss']:.5f}, grad_norm {first['grad_norm']:.5f}; "
              f"step 2 {wall * 1e3:.1f} ms ({tokens_per_s:.0f} tokens/s): "
              f"loss {metrics['loss']:.5f}, grad_norm "
              f"{metrics['grad_norm']:.5f}, lr {metrics['lr']:.3e}; "
              f"launches {launches}; flash by body {bodies}"
              + (f"; peak device memory {peak:.2f} GiB" if peak else ""))
        ln_v = float(np.log(cfg.vocab_size))
        self.paths["train_step"] = dict(
            launches=launches, flash_bodies=bodies, wall_s=wall,
            first_wall_s=first_s, tokens=b * s, tokens_per_s=tokens_per_s,
            peak_gib=peak, layers=cfg.num_layers, params=n_params,
            microbatches=micro, first=first, second=metrics)
        for m in (first, metrics):
            self.check(all(np.isfinite(v) for v in m.values())
                       and m["grad_norm"] > 0
                       and abs(m["loss"] - ln_v) < 1.0,
                       f"training metrics {m}: expected finite, grad_norm "
                       f"> 0, loss near ln V = {ln_v:.3f}")
        if not self.rehearse:
            n_flash = cfg.num_layers * micro * 2
            want = dict.fromkeys(counters, 0)
            want["flash_attention"] = n_flash
            self.check(launches == want, f"training launches {launches}, "
                                         f"expected {want}")
            self.check(bodies == {"hopper_launches": n_flash,
                                  "tf32_launches": 0,
                                  "cuda_core_launches": 0,
                                  "lse_launches": n_flash},
                       f"flash bodies {bodies}: expected every launch on "
                       f"the Hopper body with lse")

        # one profiled step: idle share, flash's share of the busy time,
        # and the device and host time of three profiler ranges: each
        # microbatch's forward and backward ("forward_backward"), inside
        # it _FlashTrain's plain-torch backward ("flash_backward"), and
        # the AdamW update ("optimizer")
        def ranged(name, fn):
            def call(*a, **k):
                with record_function(name):
                    return fn(*a, **k)
            return call
        ranges = ("forward_backward", "flash_backward", "optimizer")
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        with profile(activities=acts) as prof, \
                mock.patch.object(step_mod, "_backward", ranged(
                    "forward_backward", step_mod._backward)), \
                mock.patch.object(step_mod, "adamw_update_torch", ranged(
                    "optimizer", step_mod.adamw_update_torch)), \
                mock.patch.object(attention_mod._FlashTrain, "backward",
                                  staticmethod(ranged(
                                      "flash_backward",
                                      attention_mod._FlashTrain.backward))):
            t0 = time.perf_counter()
            state, _ = step(state, batches[2])
            self.sync()
            prof_ms = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        # kernels only: a range's own span on the device timeline is not
        # device work
        rows = sorted(((float(e.self_device_time_total), e.key, e.count)
                       for e in events if e.device_type == DeviceType.CUDA
                       and e.key not in ranges), reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3
        spans = {name: dict(
            device_ms=sum(float(e.device_time_total) for e in events
                          if e.key == name
                          and e.device_type == DeviceType.CPU) / 1e3,
            host_ms=sum(float(e.cpu_time_total) for e in events
                        if e.key == name
                        and e.device_type == DeviceType.CPU) / 1e3)
            for name in ranges}
        if busy_ms > 0:
            flash_ms = sum(r[0] for r in rows if "flash_" in r[1]) / 1e3
            print(f"  profiled step: wall {prof_ms:.1f} ms, device busy "
                  f"{busy_ms:.1f} ms, idle share "
                  f"{max(0.0, 1 - busy_ms / prof_ms):.3f}; flash kernels "
                  f"{flash_ms:.2f} ms, {flash_ms / busy_ms:.4f} of busy")
            print("  ranges (device ms, share of busy; host ms): " + ", ".join(
                f"{name} {sp['device_ms']:.1f}, "
                f"{sp['device_ms'] / busy_ms:.3f}; {sp['host_ms']:.1f}"
                for name, sp in spans.items()))
            for us, key, count in rows[:12]:
                print(f"    {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
            self.paths["train_step"]["profile"] = dict(
                wall_ms=prof_ms, busy_ms=busy_ms,
                idle_share=max(0.0, 1 - busy_ms / prof_ms),
                flash_ms=flash_ms, flash_share=flash_ms / busy_ms,
                ranges=spans, top=[(key[:90], us / 1e3, count)
                                   for us, key, count in rows[:12]])
        else:
            print("  profiler saw no device time: not measured")

        # the first step again from the same params, with the plain flash
        del state
        self.free_full_model()
        state = fresh_state()
        with mock.patch.object(attention_mod, "flash_attention",
                               flash_ref.flash_attention):
            _, plain = step(state, batches[0])
        plain = {k: float(v) for k, v in plain.items()}
        del state
        self.free_full_model()
        loss_rel = abs(first["loss"] - plain["loss"]) / abs(plain["loss"])
        norm_rel = (abs(first["grad_norm"] - plain["grad_norm"])
                    / abs(plain["grad_norm"]))
        print(f"  step 1 with the plain flash: loss {plain['loss']:.5f} "
              f"(rel gap {loss_rel:.2e}, bound {TRAIN_BF16_LOSS_REL:.2e}), "
              f"grad_norm {plain['grad_norm']:.5f} (rel gap {norm_rel:.2e}, "
              f"bound {TRAIN_BF16_NORM_REL:.2e})")
        self.paths["train_step"].update(plain_first=plain,
                                        loss_rel_gap=loss_rel,
                                        grad_norm_rel_gap=norm_rel)
        self.check(loss_rel <= TRAIN_BF16_LOSS_REL
                   and norm_rel <= TRAIN_BF16_NORM_REL,
                   "the kernel-driven step and the plain-flash step "
                   "disagree")

    def train_loop(self):
        """The restart-safe loop on full-width qwen3_1_7b (bfloat16 params,
        float32 moments, remat full, B 2 x S 2,048 in 2 microbatches, flash
        blocks of 1,024): ``Trainer`` for 3 steps with a checkpoint every
        2 into a temporary directory (an async save at step 2 overlapped
        with step 3, the final blocking save at 3), counts set to 0 just
        before ``run`` and read just after; then step_3 is deleted and a
        fresh ``Trainer`` on the directory must resume at 2 with the step-2
        values bit for bit and repeat step 3's loss within
        ``RESTART_RTOL``. Times the manager's snapshot, write-and-hash and
        restore by wrapping its functions."""
        import gc
        import shutil
        import tempfile
        import numpy as np
        torch = self.torch
        from repro_torch.ckpt import manager as manager_mod
        from repro_torch.data import DataConfig
        from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig
        self.free_full_model()
        cfg = dataclasses.replace(self.llm_config(layers=TRAIN_LOOP_LAYERS),
                                  remat="full", attn_flash_block=16
                                  if self.rehearse else 1024)
        seq, batch, micro = (64, 2, 2) if self.rehearse else (2048, 2, 2)
        oc = OptimizerConfig()
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                        global_batch=batch)
        spans = {"snapshot": [], "write": [], "restore": []}

        def timed(kind, fn):
            def call(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                spans[kind].append(time.perf_counter() - t0)
                return out
            return call
        kept = {}

        def keep_step_2(step, state, metrics):
            if step + 1 == 2:      # the state the step-2 save snapshotted
                leaves = dict(manager_mod._flatten_state_torch(state))
                kept.update({k: leaves[k].clone() for k in TRAIN_LOOP_KEEP})
        counters = wrappers()
        launches = {n: 0 for n in counters}
        lse = 0

        def run(trainer):
            nonlocal lse
            reset_counts(counters)
            self.sync()
            t0 = time.perf_counter()
            out = trainer.run()
            self.sync()
            for n, fn in counters.items():
                launches[n] += fn.launches
            lse += counters["flash_attention"].lse_launches
            return out, time.perf_counter() - t0

        with tempfile.TemporaryDirectory() as tmp, \
                mock.patch.object(manager_mod, "_snapshot_torch", timed(
                    "snapshot", manager_mod._snapshot_torch)), \
                mock.patch.object(manager_mod.CheckpointManager, "_write",
                                  timed("write", manager_mod.CheckpointManager
                                        ._write)), \
                mock.patch.object(manager_mod.CheckpointManager, "restore",
                                  timed("restore", manager_mod
                                        .CheckpointManager.restore)):
            disk = shutil.disk_usage(tmp)
            print(f"  checkpoint directory: {disk.free / 1e9:.1f} GB free of "
                  f"{disk.total / 1e9:.1f} GB")
            tc = TrainerConfig(total_steps=3, ckpt_every=2, log_every=1,
                               ckpt_dir=tmp, microbatches=micro)
            first = Trainer(cfg, oc, tc, dc, hooks=keep_step_2,
                            device=self.device)
            t0 = time.perf_counter()
            first.init_or_restore()
            self.sync()
            init_s = time.perf_counter() - t0
            n_params = sum(p.numel() for p in first.state["params"]
                           .parameters())
            out, run_s = run(first)
            walls = list(first.straggler.times["worker0"])
            step_2 = Path(tmp) / "step_2"
            ckpt_bytes = sum(f.stat().st_size for f in step_2.iterdir())
            n_files = len(list(step_2.iterdir()))
            del first
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
            shutil.rmtree(Path(tmp) / "step_3")
            second = Trainer(cfg, oc, tc, dc, device=self.device)
            t0 = time.perf_counter()
            start = second.init_or_restore()
            self.sync()
            resume_s = time.perf_counter() - t0
            leaves = dict(manager_mod._flatten_state_torch(second.state))
            equal = {k: bool(torch.equal(leaves[k], v))
                     for k, v in kept.items()}
            out2, run2_s = run(second)
            walls2 = list(second.straggler.times["worker0"])
            del second, leaves
            kept.clear()
            gc.collect()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        tokens = batch * seq
        print(f"  {cfg.name}: {cfg.num_layers} layers, {n_params} params "
              f"{cfg.param_dtype}, moments {oc.state_dtype}; B {batch} x S "
              f"{seq} in {micro} microbatches; init {init_s:.2f} s")
        print(f"  run 1: losses {[round(x, 5) for x in out['losses']]}, step "
              f"walls {[round(w * 1e3, 1) for w in walls]} ms ("
              f"{[round(tokens / w) for w in walls]} tokens/s), run {run_s:.2f}"
              f" s with the saves")
        print(f"  checkpoint: {ckpt_bytes} bytes in {n_files} files; "
              f"snapshot {[round(t, 3) for t in spans['snapshot']]} s, write "
              f"and hash {[round(t, 3) for t in spans['write']]} s ("
              f"{[round(ckpt_bytes / t / 1e9, 3) for t in spans['write']]} "
              f"GB/s), restore {[round(t, 3) for t in spans['restore']]} s")
        print(f"  resumed at step {start} in {resume_s:.2f} s (init and "
              f"restore); step-2 leaves equal bit for bit: {equal}")
        print(f"  run 2: loss {[round(x, 5) for x in out2['losses']]} vs run "
              f"1's {[round(x, 5) for x in out['losses'][2:]]}, step wall "
              f"{[round(w * 1e3, 1) for w in walls2]} ms, run {run2_s:.2f} s; "
              f"launches over both runs {launches}, with lse {lse}")
        self.paths["train_loop"] = dict(
            launches=dict(launches), layers=cfg.num_layers, params=n_params,
            losses=out["losses"], resumed_losses=out2["losses"],
            step_walls_s=walls, resumed_step_walls_s=walls2,
            tokens_per_s=[tokens / w for w in walls], ckpt_bytes=ckpt_bytes,
            snapshot_s=spans["snapshot"], write_s=spans["write"],
            restore_s=spans["restore"], init_s=init_s, resume_s=resume_s,
            disk_free_bytes=disk.free)
        ln_v = float(np.log(cfg.vocab_size))
        self.check(start == 2, f"resumed at step {start}, expected 2")
        self.check(len(equal) == len(TRAIN_LOOP_KEEP) and all(equal.values()),
                   f"restored step-2 leaves differ: {equal}")
        self.check(all(np.isfinite(out["losses"]))
                   and all(abs(x - ln_v) < 1.0 for x in out["losses"]),
                   f"losses {out['losses']}: expected finite, near ln V = "
                   f"{ln_v:.3f}")
        self.check(np.allclose(out2["losses"], out["losses"][2:],
                               rtol=RESTART_RTOL, atol=RESTART_RTOL),
                   "the resumed step's loss differs from the first run's")
        self.check(len(spans["write"]) == 3 and len(spans["restore"]) == 1,
                   f"saves {len(spans['write'])}, restores "
                   f"{len(spans['restore'])}: expected 3 and 1")
        n_flash = cfg.num_layers * micro * 2 * 4     # 3 steps, then 1
        want = {"flash_attention": n_flash}
        self.check_launches(launches, want, "training loop")
        if not self.rehearse:
            self.check(lse == n_flash, f"flash lse launches {lse}, "
                                       f"expected {n_flash}")

    def elastic_resolve(self):
        """``ElasticController`` over the scheduler phase's fleet (20,000
        jobs x 256 pods) with the port's ``schedule`` on the card (PS-DSF
        RDM, float64, Jacobi rounds of the bisect fill on the dense layout,
        ``SCHED_ROUNDS``) as its ``solve_fn``: the initial solve, then every
        pod beats at t = 0, ``ELASTIC_SILENT`` healthy ones go silent, and
        ``on_tick(25.0)`` marks them failed and re-solves; counts set to 0
        before and read after ((R+1) ``psdsf_fill`` launches a round, R =
        5). Each allocation is held against the same controller driven
        with the plain versions (1e-9 a job, equal rounds)."""
        from repro_torch.ft import ElasticController
        from repro_torch.sched import cluster as cluster_mod
        kw = dict(fill="bisect", round="jacobi", layout="dense",
                  max_rounds=SCHED_ROUNDS, device=self.device)
        solve = cluster_mod.solve

        def drive(plain):
            rounds = []

            def recorded(*a, **k):
                alloc, info = solve(*a, **k)
                rounds.append(info.rounds)
                return alloc, info
            fleet, jobs, _, _ = self.sched_fleets()
            stack = self.plain_versions() if plain else contextlib.ExitStack()
            with stack, mock.patch.object(cluster_mod, "solve", recorded):
                self.sync()
                t0 = time.perf_counter()
                ctl = ElasticController(
                    fleet, jobs,
                    lambda c, j: cluster_mod.schedule(c, j, **kw),
                    heartbeat_timeout_s=10.0)
                self.sync()
                init_s = time.perf_counter() - t0
                before = dict(ctl.allocation)
                healthy = [p.name for p in fleet.pods if p.healthy]
                silent = healthy[::len(healthy) // ELASTIC_SILENT][
                    :ELASTIC_SILENT]
                for p in fleet.pods:
                    ctl.monitor.beat(p.name, 0.0)
                    if p.name not in silent:
                        ctl.monitor.beat(p.name, 20.0)
                t0 = time.perf_counter()
                after = ctl.on_tick(25.0, {})
                self.sync()
                tick_s = time.perf_counter() - t0
            return dict(ctl=ctl, before=before, after=after, rounds=rounds,
                        walls=(init_s, tick_s), silent=silent,
                        resources=fleet.problem(jobs[:1]).num_resources)

        counters = wrappers()
        reset_counts(counters)
        run = drive(plain=False)
        launches = {n: fn.launches for n, fn in counters.items()}
        twin = drive(plain=True)
        ctl = run["ctl"]
        failed = [e.worker for e in ctl.events if e.reason == "failure"]
        fell = [j for j in run["before"]
                if run["after"][j] < run["before"][j] - F64_ATOL]
        diff = max(abs(run[k][j] - twin[k][j]) for k in ("before", "after")
                   for j in run[k])
        print(f"  {len(run['before'])} jobs on {len(ctl.cluster.pods)} pods; "
              f"silent {run['silent']}; failure events {failed}")
        print(f"  solve walls (initial, re-solve): "
              f"{[round(w, 3) for w in run['walls']]} s with the kernel, "
              f"{[round(w, 3) for w in twin['walls']]} s plain-driven; rounds "
              f"{run['rounds']} / {twin['rounds']}; psdsf_fill launches "
              f"{launches['psdsf_fill']}")
        print(f"  replicas {sum(run['before'].values()):.3f} -> "
              f"{sum(run['after'].values()):.3f}; {len(fell)} jobs' replicas "
              f"fell; kernel vs plain-driven max|d replicas| {diff:.3e}")
        self.paths["elastic"] = dict(
            launches=launches, rounds=run["rounds"], walls_s=run["walls"],
            plain_walls_s=twin["walls"], jobs_fell=len(fell),
            max_abs_diff=diff, silent=run["silent"])
        self.check(sorted(failed) == sorted(run["silent"])
                   and len(failed) == ELASTIC_SILENT,
                   f"failure events {failed}, expected {run['silent']}")
        self.check(run["rounds"] == twin["rounds"] and diff <= F64_ATOL,
                   "elastic re-solve: kernel and plain runs disagree")
        self.check(sum(run["after"].values()) < sum(run["before"].values()),
                   "losing pods did not shrink the allocation")
        self.check_launches(launches, {"psdsf_fill": (run["resources"] + 1)
                                       * sum(run["rounds"])},
                            "elastic re-solve")

    # -- the sharing-property checkers and Section IV's gamma-direct solve --
    def certify(self, alloc, checks, tol, label, gate):
        """Run ``checks`` (port checkers) on ``alloc`` on the card: print
        each verdict, its margin and its time; with ``gate``, every one
        must hold. Returns {checker: (ok, detail, margin, ms)}."""
        out = {}
        for check in checks:
            self.sync()
            t0 = time.perf_counter()
            verdict = check(alloc, tol, device=self.device)
            self.sync()
            ms = (time.perf_counter() - t0) * 1e3
            print(f"    {label} {check.__name__}: {verdict.ok} "
                  f"({verdict.detail}), margin {verdict.margin:.3e}, "
                  f"{ms:.1f} ms")
            out[check.__name__] = dict(ok=verdict.ok, detail=verdict.detail,
                                       margin=verdict.margin, ms=ms,
                                       where=list(verdict.where))
            if gate:
                self.check(verdict.ok, f"{label}: {check.__name__} fails at "
                                       f"a converged fixed point: "
                                       f"{verdict.detail}")
        return out

    def properties_path(self):
        """The sharing-property checkers on the card, at the pin. For each
        PS-DSF mechanism, ``engine.solve`` (float64, Jacobi rounds of the
        bisect fill, the buckets) until ``SolveInfo.converged`` at tol 1e-9
        within ``PROPERTY_ROUNDS``; every property the reference's
        guarantee matrix lists for it (and Theorem 1 for RDM) checked at
        the reference tests' tolerance, max(1e-5, 10 x residual), each
        verdict printed with its margin and its time. One rule for every
        solve: a property is gated where the solve reached its tol (a fixed
        point); an iterate that stopped in the loose band
        (``SolveInfo.approx``) is no fixed point, and its verdicts are
        printed, not gated. drf and uniform (host closed forms) are gated.
        One violation of each kind planted in a copy of the pin's
        allocations must be caught where it was planted, at the tolerance
        that allocation is checked at; the checkers on the card are held
        against the same checkers on the CPU on a 2,000 x 64 cut (equal
        verdicts, texts and offenders). Counts set to 0 before and read
        after: the bucketed fill 5 x the RDM rounds and once a TDM round,
        ``psdsf_vds`` once a Pareto check on the card."""
        from repro_torch.core import engine
        from repro_torch.core import properties as P
        from repro_torch.core.instances import sparse_cell_instance
        pin = self.pin
        counters = wrappers()
        reset_counts(counters)
        record = dict(solves={}, verdicts={}, planted={}, cut={})
        want = {"psdsf_fill_bucketed": 0, "psdsf_vds": 0}
        theorem1 = (P.check_bottleneck_structure_rdm_torch,)
        solved = {}
        for mech in ("psdsf-rdm", "psdsf-tdm"):
            mode = mech[-3:]
            events = 5 if mode == "rdm" else 1
            checks = P.ALLOCATOR_GUARANTEES_TORCH[mech] + (
                theorem1 if mode == "rdm" else ())
            self.sync()
            t0 = time.perf_counter()
            alloc, info = engine.solve(pin, mech, device=self.device,
                                       fill="bisect", round="jacobi",
                                       tol=PROPERTY_TOL,
                                       max_rounds=PROPERTY_ROUNDS)
            self.sync()
            wall = time.perf_counter() - t0
            want["psdsf_fill_bucketed"] += events * info.rounds
            print(f"  {mech} engine.solve: {wall:.3f} s, layout "
                  f"{info.layout}, rounds {info.rounds}, residual "
                  f"{info.residual:.3e}, converged {info.converged} "
                  f"(approx {info.approx}, rounds_to_tol "
                  f"{info.rounds_to_tol})")
            self.check(info.converged, f"{mech}: no fixed point in "
                                       f"{info.rounds} rounds")
            if info.approx:
                print(f"    {mech}: stopped in the loose band, not at tol "
                      f"{PROPERTY_TOL:g}: no fixed point, verdicts printed, "
                      f"not gated")
            tol = max(PROPERTY_CHECK_TOL, 10.0 * info.residual)
            verdicts = self.certify(alloc, checks, tol, mech,
                                    gate=not info.approx)
            want["psdsf_vds"] += mode == "tdm"
            solved[mode] = (alloc, tol)
            record["solves"][mech] = dict(
                wall_s=wall, rounds=info.rounds, residual=info.residual,
                approx=info.approx, gated=not info.approx)
            record["verdicts"][mech] = dict(verdicts, tol=tol)
        for mech in ("drf", "uniform"):
            alloc, _ = engine.solve(pin, mech, device=self.device)
            record["verdicts"][mech] = self.certify(
                alloc, P.ALLOCATOR_GUARANTEES_TORCH[mech],
                PROPERTY_CHECK_TOL, mech, gate=True)
        record["envy_product"] = self.envy_product(solved["rdm"][0])
        launches = {n: fn.launches for n, fn in counters.items()}
        self.check_launches(launches, want, "properties path")
        print(f"  launches on the properties path: {launches}")
        record["launches"] = launches
        self.planted_violations(solved, record)
        self.checkers_card_vs_cpu(
            sparse_cell_instance(**(dict(num_users=200, num_servers=16,
                                         cells=4) if self.rehearse
                                    else PROPERTY_CUT))[0], record)
        self.paths["properties"] = record

    def envy_product(self, alloc):
        """The envy check's float64 product S = E x^T at the pin, tile by
        tile as the checker forms it, timed with CUDA events, against its
        bound at the H100's float64 tensor-core rate."""
        torch = self.torch
        from repro_torch.core.properties import ENVY_TILE
        x = torch.as_tensor(alloc.x, dtype=torch.float64, device=self.device)
        e = torch.as_tensor(self.pin_gamma > 0, dtype=torch.float64,
                            device=self.device)
        n, k = x.shape

        def product():
            for n0 in range(0, n, ENVY_TILE):
                e[n0:n0 + ENVY_TILE] @ x.T
        ms = self.time_ms(product, 3)
        flops = 2.0 * n * n * k
        nbytes = 2 * n * k * 8
        bound_ms = max(flops / PEAK_F64_TENSOR_FLOPS,
                       nbytes / PEAK_BYTES_PER_S) * 1e3
        print(f"  envy product S = E x^T, {n} x {n} x {k} float64 in tiles "
              f"of {ENVY_TILE}: {ms:.3f} ms, bound {bound_ms:.3f} ms "
              f"({flops / 1e9:.1f} GFLOP at {PEAK_F64_TENSOR_FLOPS / 1e12:.0f}"
              f" TFLOP/s float64 tensor cores; "
              f"{flops / PEAK_FLOPS['float64'] * 1e3:.3f} ms at the "
              f"{PEAK_FLOPS['float64'] / 1e12:.0f} TFLOP/s outside them)")
        return dict(ms=ms, bound_ms=bound_ms, gflop=flops / 1e9,
                    shape=f"{n}x{n}x{k}", tile=ENVY_TILE)

    def planted_violations(self, solved, record):
        """One violation of each kind planted in a copy of the pin's
        allocations (``solved``: the RDM and TDM solves, each with the
        tolerance it is checked at), each caught by the checker on the
        card at the planted index, at that tolerance."""
        import numpy as np
        from repro_torch.core import properties as P
        from repro_torch.core.types import Allocation
        pin, g = self.pin, self.pin_gamma
        (rdm, tol_rdm), (tdm, tol_tdm) = solved["rdm"], solved["tdm"]
        x_rdm, x_tdm = rdm.x, tdm.x
        first = int(np.argmax((g > 0).any(axis=0)))
        jitter = 1.0 + 1e-3 * np.arange(1, pin.num_users + 1) / pin.num_users
        busiest = int(np.argmax(x_rdm.sum(axis=0)))
        # the user user 0 would envy first once it holds 2x: the largest
        # of 0's utilities of the others' bundles on 0's servers
        xn = x_rdm.sum(axis=1)
        s0 = x_rdm[:, g[0] > 0].sum(axis=1)
        d = pin.demands
        mask = d[0] > 0
        u0 = (pin.weights[0] / pin.weights) * s0 * np.min(
            d[:, mask] / d[0, mask], axis=1)
        u0[0] = 0.0
        m = int(np.argmax(u0))
        lowest = int(np.argmax(g[:, first] > 0))
        # kind: (base allocation, its tolerance, the factors planted in its
        # copy, the checker, the index it must report: the doubled server
        # for the capacity, whichever of its resources is over by the most)
        plants = {
            "capacity": (x_rdm, tol_rdm, {(slice(None), busiest): 2.0},
                         P.check_feasible_rdm_torch, (busiest,)),
            "uniform share": (x_rdm, tol_rdm, {0: 0.0},
                              P.check_sharing_incentive_torch, (0,)),
            "envied user": (x_rdm, tol_rdm, {m: 2.0 * xn[0] / u0[m]},
                            P.check_envy_freeness_torch, (0, m)),
            "time share": (x_tdm, tol_tdm,
                           {(slice(None), first): 0.5 * jitter},
                           P.check_pareto_tdm_torch, (first,)),
            "no bottleneck": (x_rdm, tol_rdm,
                              {(slice(None), first): 0.5 * jitter},
                              P.check_bottleneck_structure_rdm_torch,
                              (lowest, first)),
        }
        for kind, (base, tol, scale, check, want) in plants.items():
            x = base.copy()
            for at, factor in scale.items():
                x[at] = x[at] * factor
            verdict = check(Allocation(pin, x), tol, device=self.device)
            print(f"    planted {kind}: {check.__name__} -> {verdict.ok} "
                  f"({verdict.detail}), at {verdict.where}")
            record["planted"][kind] = dict(ok=verdict.ok,
                                           detail=verdict.detail,
                                           where=list(verdict.where))
            self.check(not verdict.ok and verdict.where[:len(want)] == want,
                       f"planted {kind} not caught where planted")

    def checkers_card_vs_cpu(self, cut, record):
        """Every checker on the card and on the CPU on the same
        allocations of ``cut``: its PS-DSF solves on the card (256
        rounds, tol 1e-9) and copies with a planted violation of each
        kind; equal verdicts, texts (numbers within 1e-9 relative) and
        offenders."""
        import re
        import numpy as np
        from repro_torch.core import engine
        from repro_torch.core import properties as P
        from repro_torch.core.types import Allocation
        number = re.compile(r"[-+]?\d+\.\d+(?:e[-+]?\d+)?")
        checks = (P.check_feasible_rdm_torch, P.check_feasible_tdm_torch,
                  P.check_sharing_incentive_torch,
                  P.check_envy_freeness_torch, P.check_pareto_tdm_torch,
                  P.check_bottleneck_structure_rdm_torch)
        allocs = []
        for mech in ("psdsf-rdm", "psdsf-tdm"):
            alloc, _ = engine.solve(cut, mech, device=self.device,
                                    fill="bisect", round="jacobi",
                                    tol=PROPERTY_TOL,
                                    max_rounds=PROPERTY_ROUNDS)
            x = alloc.x
            allocs.append((mech, x))
            allocs.append((f"{mech}, column 0 halved", x * np.where(
                np.arange(x.shape[1]) == 0, 0.5, 1.0)))
            allocs.append((f"{mech}, user 1 x3", x * np.where(
                np.arange(x.shape[0])[:, None] == 1, 3.0, 1.0)))
        compared = 0
        for label, x in allocs:
            for check in checks:
                got = check(Allocation(cut, x), PROPERTY_CHECK_TOL,
                            device=self.device)
                want = check(Allocation(cut, x), PROPERTY_CHECK_TOL,
                             device="cpu")
                same = (got.ok == want.ok and got.where == want.where
                        and number.sub("#", got.detail)
                        == number.sub("#", want.detail)
                        and all(abs(float(a) - float(b))
                                <= 1e-9 * max(abs(float(b)), 1e-12)
                                for a, b in zip(number.findall(got.detail),
                                                number.findall(
                                                    want.detail))))
                self.check(same, f"cut {label} {check.__name__}: card "
                                 f"{got} at {got.where} vs CPU {want} at "
                                 f"{want.where}")
                compared += 1
        print(f"  checkers on a {cut.num_users}x{cut.num_servers} cut: "
              f"{compared} verdicts, card equal to CPU (texts, offenders)")
        record["cut"] = dict(shape=f"{cut.num_users}x{cut.num_servers}",
                             compared=compared)

    def gamma_instance(self):
        """Section IV's co-processor scenario at the pin's scale: the pin's
        gamma; a seeded eighth of the servers get a co-processor that a
        seeded quarter of the users can use at ``COPROCESSOR_SPEEDUP``."""
        import numpy as np
        from repro_torch.core.extensions import (COPROCESSOR_SPEEDUP,
                                                 GammaProblem)
        g = self.pin_gamma.copy()
        n, k = g.shape
        rng = np.random.default_rng(GAMMA_SEED)
        servers = rng.choice(k, max(1, k // 8), replace=False)
        users = rng.choice(n, max(1, n // 4), replace=False)
        g[np.ix_(users, servers)] *= COPROCESSOR_SPEEDUP
        return GammaProblem(g, self.pin.weights), servers, users

    def gamma_path(self):
        """``solve_psdsf_gamma_tdm_torch`` on the co-processor scenario at
        the pin's scale (float64): Jacobi rounds of the bisect fill, 32 at
        tol 0, on the dense layout and on the buckets, counts set to 0
        just before each (one TDM event of the layout's fill kernel a
        round), each held against its plain-driven solve (1e-9, equal
        rounds); then Anderson-mixed rounds on the buckets to tol 1e-6 x
        max gamma, certified by ``check_feasible_tdm_torch``,
        ``check_sharing_incentive_torch`` and ``check_pareto_tdm_torch``
        (one ``psdsf_vds`` launch) at max(1e-5, 10 x residual); then one
        TDM event of ``psdsf_fill`` timed against its plain version and
        its bound."""
        import numpy as np
        from repro_torch.core import properties as P
        from repro_torch.core.extensions import solve_psdsf_gamma_tdm_torch
        from repro_torch.core.types import Allocation
        prob, servers, users = self.gamma_instance()
        print(f"  co-processor instance: {prob.gamma.shape[0]} users x "
              f"{prob.gamma.shape[1]} servers, {len(servers)} servers with "
              f"a co-processor, {len(users)} users that use it, max gamma "
              f"{prob.gamma.max():.3f}")
        counters = wrappers()
        record = {"runs": {}}
        launches = {n: 0 for n in counters}
        for layout, kernel in (("dense", "psdsf_fill"),
                               ("bucketed", "psdsf_fill_bucketed")):
            kw = dict(max_rounds=32, tol=0.0, fill="bisect", round="jacobi",
                      layout=layout, device=self.device)
            reset_counts(counters)
            self.sync()
            t0 = time.perf_counter()
            x, shares, info = solve_psdsf_gamma_tdm_torch(prob, **kw)
            self.sync()
            wall = time.perf_counter() - t0
            run = {n: fn.launches for n, fn in counters.items()}
            self.check_launches(run, {kernel: info.rounds},
                                f"gamma-direct {layout} path")
            with self.plain_versions():
                x_p, _, info_p = solve_psdsf_gamma_tdm_torch(prob, **kw)
            diff = float(np.abs(x - x_p).max())
            print(f"  {layout}: {wall:.3f} s, rounds {info.rounds}, residual "
                  f"{info.residual:.3e}, {kernel} launches {run[kernel]}; "
                  f"vs plain-driven max|dx|={diff:.3e}; time shares per "
                  f"server in [{shares.sum(axis=0).min():.12f}, "
                  f"{shares.sum(axis=0).max():.12f}]")
            self.check(diff <= F64_ATOL and info.rounds == info_p.rounds
                       and info.layout == layout,
                       f"gamma-direct {layout}: kernel-driven and "
                       f"plain-driven solves disagree")
            record["runs"][layout] = dict(wall_s=wall, rounds=info.rounds,
                                          residual=info.residual,
                                          max_abs_diff=diff)
            for n in launches:
                launches[n] += run[n]
        reset_counts(counters)
        self.sync()
        t0 = time.perf_counter()
        x, shares, info = solve_psdsf_gamma_tdm_torch(
            prob, max_rounds=GAMMA_ROUNDS, tol=GAMMA_TOL, fill="bisect",
            round="jacobi", layout="bucketed", accel="anderson",
            device=self.device)
        self.sync()
        wall = time.perf_counter() - t0
        totals = x.sum(axis=1)
        speed = np.zeros(prob.gamma.shape[0], dtype=bool)
        speed[users] = True
        print(f"  to convergence (Anderson, buckets): {wall:.3f} s, rounds "
              f"{info.rounds}, residual {info.residual:.3e} (limit "
              f"{GAMMA_TOL * max(1.0, prob.gamma.max()):.3e}), converged "
              f"{info.converged}, Anderson {info.accel_hits} accepted / "
              f"{info.accel_rejects} rejected; mean total of the users with "
              f"the co-processor {totals[speed].mean():.4f}, without "
              f"{totals[~speed].mean():.4f}")
        self.check(info.converged, "gamma-direct: no fixed point in "
                                   f"{info.rounds} rounds")
        tol = max(PROPERTY_CHECK_TOL, 10.0 * info.residual)
        record["certified"] = self.certify(
            Allocation(prob, x), (P.check_feasible_tdm_torch,
                                  P.check_sharing_incentive_torch,
                                  P.check_pareto_tdm_torch), tol,
            "gamma-direct", gate=not info.approx)
        run = {n: fn.launches for n, fn in counters.items()}
        self.check_launches(run, {"psdsf_fill_bucketed": info.rounds,
                                  "psdsf_vds": 1}, "gamma-direct solve")
        for n in launches:
            launches[n] += run[n]
        record.update(launches=launches, converged=dict(
            wall_s=wall, rounds=info.rounds, residual=info.residual,
            accel_hits=info.accel_hits, accel_rejects=info.accel_rejects,
            tol=tol))
        self.tdm_event(prob)
        self.paths["gamma_direct"] = record

    def tdm_event(self, prob):
        """One TDM saturation event of ``psdsf_fill`` over the
        co-processor instance, as ``ops.fill_cluster`` builds it in TDM
        mode (unit demands and capacities, rate phi where eligible, some
        users frozen), held against its plain version and timed."""
        import numpy as np
        torch = self.torch
        from repro_torch.kernels.psdsf_fill import kernel, ref
        g = prob.gamma
        n, k = g.shape
        rng = np.random.default_rng(GAMMA_SEED)
        x_ext = rng.uniform(0.0, 2.0, (n, k)) * (g > 0)
        full = np.where(g > 0, prob.weights[:, None] * g, 0.0)
        floors = np.where(g > 0, x_ext / np.maximum(full, 1e-300), 0.0)
        active = (g > 0) & (rng.random((n, k)) > 0.2)
        rate = np.where(active, prob.weights[:, None], 0.0)

        def t(a, dtype=torch.float64):
            return torch.as_tensor(a, dtype=dtype,
                                   device=self.device).contiguous()
        args = [t(np.where(active, floors, 0.0)), t(rate), t(np.ones((n, 1))),
                t(np.ones((k, 1))), t(np.zeros((k, 1))),
                t(np.zeros((k, 1), dtype=bool), torch.bool),
                t(rng.uniform(0.0, 0.5, k))]
        steps = 48
        got = kernel.fill_event_levels(*args, steps=steps)
        want = ref.fill_event_levels(*args, steps=steps)
        self.sync()
        err = self.compare_event(got, want, "tdm", "psdsf_fill")
        r, b = 1, 8
        nbytes = (2 * n * k + n * r + 2 * k * r + k) * b + k * r \
            + (k + 3 * k * r) * b
        nnz = int((args[1] > 0).sum())
        flops = (steps + 3) * nnz * (2 * r + 3)
        bound_ms, bound_by = self.bound(nbytes, flops, "float64")
        ms, eager_ms = self.timed(lambda: kernel.fill_event_levels(
            *args, steps=steps), 10)
        plain_ms = self.time_ms(lambda: ref.fill_event_levels(
            *args, steps=steps), 3)
        print(f"  tdm event {n}x{k} R=1 steps={steps}: kernel {ms:.4f} ms "
              f"({eager_ms:.4f} ms back to back), plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.3f} GFLOP over {nnz} entries of rate > 0: "
              f"bound by {bound_by})")
        self.rows[("psdsf_fill", "tdm")] = dict(
            ms=ms, eager_ms=eager_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, max_abs_err=err, shape=f"{n}x{k}x1")

    # -- the decode over a cache sharded on its head dim --------------------
    def headdim_decode(self):
        """The 2-layer full-width qwen3_1_7b (bf16, seeded init) on a 2 x 2
        mesh of ``HEADDIM_RANKS`` gloo ranks on the one card
        (``headdim_decode_rank``, spawned as "pod mean" spawns its ranks):
        a sharded prefill of the batch, then ``HEADDIM_STEPS`` decode steps
        over a cache sharded on its head dim (``decode_cache_shard=
        "headdim"``) and, as its twin, on its sequence ("seq", split-KV).
        Each run's logits, prefill and every step, are held against the
        same steps unsharded in this process (flash and the decode kernel,
        counts set to 0 before, read after), within 2^-5 x max|logit|, and
        its greedy tokens must equal the unsharded run's wherever the top
        two logits differ by more than that bound."""
        import multiprocessing
        import tempfile
        torch = self.torch
        from repro_torch.models import model as tmodel
        self.free_full_model()
        cfg, _ = headdim_config(self.rehearse)
        prompt, feed, rows = headdim_inputs(cfg, self.rehearse)
        b, s = prompt.shape
        counters = wrappers()
        reset_counts(counters)
        params = tmodel.init_params(cfg, HEADDIM_SEED, device=self.device)
        logits, pre = tmodel.forward_prefill(cfg, params, prompt,
                                             device=self.device)
        caches = tmodel.init_caches(cfg, b, rows, device=self.device)
        for c, p in zip(caches, pre):
            for key in ("k", "v"):
                c[key][:, :s] = p[key]
        del pre
        plain = [logits.float().cpu()]
        for i, tok in enumerate(feed):
            logits, caches = tmodel.forward_decode(cfg, params, caches, tok,
                                                   s + i,
                                                   device=self.device)
            plain.append(logits.float().cpu())
        self.sync()
        launches = {n: fn.launches for n, fn in counters.items()}
        self.check_launches(launches, {
            "flash_attention": cfg.num_layers,
            "decode_attention": cfg.num_layers * len(feed)},
            "unsharded twin")
        del params, caches
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        spawn = multiprocessing.get_context("spawn")
        record = dict(unsharded_launches=launches, runs={})
        shards = ("headdim", "seq")
        with tempfile.TemporaryDirectory() as tmp:
            procs = [spawn.Process(target=headdim_decode_rank, args=(
                r, HEADDIM_RANKS, f"file://{tmp}/store", tmp, shards,
                self.rehearse)) for r in range(HEADDIM_RANKS)]
            t0 = time.perf_counter()
            for p in procs:
                p.start()
            try:
                for p in procs:
                    p.join(max(1.0, HEADDIM_TIMEOUT
                               - (time.perf_counter() - t0)))
            finally:
                for p in procs:
                    if p.is_alive():
                        p.kill()
                        p.join()
            wall = time.perf_counter() - t0
            codes = [p.exitcode for p in procs]
            if codes != [0] * HEADDIM_RANKS:
                for r in range(HEADDIM_RANKS):
                    fault = Path(tmp) / f"fault{r}.txt"
                    if fault.exists() and fault.stat().st_size:
                        print(f"  rank {r}:\n{fault.read_text()[-3000:]}")
            self.check(codes == [0] * HEADDIM_RANKS,
                       f"headdim decode ranks exited {codes}")
            print(f"  {HEADDIM_RANKS} gloo ranks, both cache layouts: "
                  f"processes {wall:.1f} s (gloo copies each collective "
                  f"through the host: the times below say nothing of "
                  f"NVLink)")
            for shard in shards:
                ranks = [json.loads((Path(tmp) / f"{shard}_rank{r}.json")
                                    .read_text())
                         for r in range(HEADDIM_RANKS)]
                got = torch.load(Path(tmp) / f"{shard}.pt")
                r0 = ranks[0]
                steps_ms = [round(1e3 * w, 3) for w in r0["step_s"]]
                print(f"  {shard}: on {r0['device']}, cache placements "
                      f"{r0['placements']}; prefill "
                      f"{1e3 * r0['prefill_s']:.1f} ms, decode steps (ms, "
                      f"rank 0) {steps_ms}; launches a rank "
                      f"{[r['launches'] for r in ranks]}; peak GiB "
                      f"{[r['peak_gib'] for r in ranks]}")
                err = self.compare_sharded_logits(cfg, got, plain, shard)
                if not self.rehearse:
                    self.check(all(r["launches"]["decode_attention"] == (
                        0 if shard == "headdim" else cfg.num_layers
                        * len(feed)) for r in ranks),
                        f"{shard}: decode kernel launches "
                        f"{[r['launches'] for r in ranks]}")
                record["runs"][shard] = dict(
                    placements=r0["placements"],
                    prefill_ms=1e3 * r0["prefill_s"], step_ms=steps_ms,
                    max_abs_err=err,
                    launches=[r["launches"] for r in ranks])
            record["processes_s"] = wall
        total = dict(launches)
        for run in record["runs"].values():
            for ranked in run["launches"]:
                for n in total:
                    total[n] += ranked[n]
        record["launches"] = total
        self.paths["headdim_decode"] = record

    def compare_sharded_logits(self, cfg, got, plain, what):
        """A sharded run's logits (prefill, then each step) against the
        unsharded run's: 2^-5 x max|logit|, and equal greedy tokens where
        the unsharded run's top two logits are further apart than that."""
        torch = self.torch
        errs = []
        for i, (a, b) in enumerate(zip(got, plain)):
            a, b = a[:, :cfg.vocab_size].float(), b[:, :cfg.vocab_size]
            err = float((a - b).abs().max())
            bound = LOGIT_REL * float(b.abs().max())
            top2 = b.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > bound
            same = a.argmax(-1) == b.argmax(-1)
            print(f"    {what} {'prefill' if i == 0 else f'step {i}'}: "
                  f"max|sharded-unsharded|={err:.4e} (bound {bound:.4e}), "
                  f"greedy tokens equal {int(same.sum())}/{len(same)} "
                  f"({int(clear.sum())} clear of a near tie)")
            self.check(bool(torch.isfinite(a).all()) and err <= bound,
                       f"{what}: sharded and unsharded logits disagree")
            self.check(bool((same | ~clear).all()),
                       f"{what}: a greedy token differs outside a near tie")
            errs.append(err)
        self.check(len(got) == len(plain), f"{what}: {len(got)} steps")
        return max(errs)

    # -- the launch tooling --------------------------------------------------
    def start_dry_runs(self):
        """Start ``DRYRUN_CHAINS`` in the background, one shell a chain of
        ``launch/dryrun.py`` CLI runs writing into a temporary directory
        (smoke configs in a rehearsal); "launch dry run" collects them."""
        import tempfile
        self.dryrun_dir = tempfile.TemporaryDirectory()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        self.dryrun_procs = []
        for i, chain in enumerate(DRYRUN_CHAINS):
            cmds = []
            for arch, shape, extra in chain:
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out",
                       self.dryrun_dir.name, "--force", *extra]
                if self.rehearse:
                    cmd.append("--smoke")
                cmds.append(" ".join(cmd))
            log = open(Path(self.dryrun_dir.name) / f"chain{i}.log", "w")
            self.dryrun_procs.append((subprocess.Popen(
                ["nice", "-n", "19", "timeout", "-k", "10",
                 str(DRYRUN_TIMEOUT), "sh", "-c",
                 " && ".join(cmds)], env=env, cwd=ROOT, stdout=log,
                stderr=subprocess.STDOUT), log))
        self.dryrun_t0 = time.perf_counter()

    def stop_dry_runs(self):
        """Stop any chain still running (every exit path calls it)."""
        for proc, log in getattr(self, "dryrun_procs", ()):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        self.dryrun_procs = []
        if getattr(self, "dryrun_dir", None) is not None:
            self.dryrun_dir.cleanup()
            self.dryrun_dir = None

    def pod_mean(self):
        """``compressed_cross_pod_mean_torch`` on ``POD_RANKS`` ranks
        (``pod_mean_rank``), each joined with a timeout; every rank must
        exit 0 and rank 0's plain check find every leaf equal."""
        import multiprocessing
        import tempfile
        torch = self.torch
        self.free_full_model()
        if self.device.type == "cuda":
            print(f"  device memory before: "
                  f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                  f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} "
                  f"GiB reserved in this process")
        backend = ("nccl" if not self.rehearse
                   and torch.cuda.device_count() >= POD_RANKS else "gloo")
        spawn = multiprocessing.get_context("spawn")
        with tempfile.TemporaryDirectory() as tmp:
            init = f"file://{tmp}/store"
            procs = [spawn.Process(target=pod_mean_rank, args=(
                r, POD_RANKS, init, tmp, backend, self.rehearse))
                for r in range(POD_RANKS)]
            t0 = time.perf_counter()
            for p in procs:
                p.start()
            try:
                for p in procs:
                    p.join(max(1.0, POD_TIMEOUT - (time.perf_counter()
                                                   - t0)))
            finally:
                for p in procs:
                    if p.is_alive():
                        p.kill()
                        p.join()
            codes = [p.exitcode for p in procs]
            self.check(codes == [0] * POD_RANKS,
                       f"pod-mean ranks exited {codes}")
            ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                     for r in range(POD_RANKS)]
        r0 = ranks[0]
        print(f"  backend {backend}, {POD_RANKS} ranks: {POD_ARCH}'s "
              f"{r0['leaves']} parameter shapes, {r0['values']} float32 "
              f"values a rank; input devices "
              f"{[r['input_devices'] for r in ranks]}, output devices "
              f"{[r['output_devices'] for r in ranks]}")
        print(f"  seconds (EF rounds + all_reduce + divide) "
              f"{[round(r['seconds'], 3) for r in ranks]}; estimates "
              f"{r0['estimate_bytes'] / 1e9:.3f} GB a rank summed as "
              f"float32 (the int8 wire format would carry "
              f"{r0['int8_wire_bytes'] / 1e9:.3f} GB); peak device memory "
              f"{[r['peak_gib'] for r in ranks]} GiB; the plain check "
              f"{r0['plain_seconds']:.1f} s: unequal mean leaves "
              f"{len(r0['unequal_mean'])}, residual leaves "
              f"{len(r0['unequal_res'])}")
        self.paths["pod_mean"] = dict(backend=backend, ranks=ranks)
        self.check(all(d.startswith(self.device.type)
                       for r in ranks for d in r["input_devices"]
                       + r["output_devices"]),
                   "a pod-mean tensor left the card")
        self.check(not r0["unequal_mean"] and not r0["unequal_res"],
                   f"the mean or residuals differ from the plain version: "
                   f"{r0['unequal_mean'][:4]} {r0['unequal_res'][:4]}")

    def dry_run_results(self):
        """Wait for the chains (their time limit), then read every
        result; each must be ``ok``."""
        for proc, _ in self.dryrun_procs:
            proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT + 30 - (
                time.perf_counter() - self.dryrun_t0)))
        out = Path(self.dryrun_dir.name)
        codes = [proc.returncode for proc, _ in self.dryrun_procs]
        if codes != [0] * len(codes):
            for log in sorted(out.glob("chain*.log")):
                print(log.read_text()[-3000:])
        self.check(codes == [0] * len(codes),
                   f"dry-run chains exited {codes}")
        results = {p.stem: json.loads(p.read_text())
                   for p in sorted(out.glob("*.json"))}
        bad = [k for k, r in results.items() if not r.get("ok")]
        for k in bad:
            print(f"  {k}: {results[k].get('error')}\n"
                  f"{results[k].get('traceback', '')[-2500:]}")
        self.check(not bad and len(results) == sum(map(len, DRYRUN_CHAINS)),
                   f"dry-run cells failed or missing: {bad}, have "
                   f"{sorted(results)}")
        return results

    def launch_dry_run(self):
        """The full-depth plans of the depth-cut models and qwen3's
        train_4k on the production mesh (``DRYRUN_CHAINS``)."""
        from repro_torch.launch import roofline
        results = self.dry_run_results()
        print(f"  chains done {time.perf_counter() - self.dryrun_t0:.1f} s "
              f"after their start")
        rows = []
        for key, r in results.items():
            if key.endswith("_card"):
                continue
            mem = r["memory_analysis"]
            arg_gb = mem["argument_size_in_bytes"] / 1e9
            temp_gb = mem["temp_size_in_bytes"] / 1e9
            counts = {k: c["count"] for k, c in r["collectives"].items()
                      if c["count"]}
            print(f"  {r['arch']} {r['shape']} ({r['layers']} layers, "
                  f"{r['devices']} devices {r['mesh_shape']['shape']}): "
                  f"per device {arg_gb:.3f} GB arguments + {temp_gb:.3f} GB "
                  f"temp = {arg_gb + temp_gb:.3f} of the card's {CARD_GB} "
                  f"GB; collectives {counts}; traced in {r['trace_s']} s; "
                  f"local_map regions {r['local_regions']}")
            rows.append(roofline.analyze_artifact_np(r))
        print("\n".join("  " + line for line in
                        roofline.format_table_np(rows).splitlines()))
        self.paths["launch_dry_run"] = {
            key: dict(arch=r["arch"], shape=r["shape"], layers=r["layers"],
                      devices=r["devices"],
                      memory_analysis=r["memory_analysis"],
                      cost_analysis=r["cost_analysis"],
                      collectives={k: c["count"] for k, c in
                                   r["collectives"].items()},
                      trace_s=r["trace_s"])
            for key, r in results.items()}

    def roofline_card(self):
        """The (1, 1) dry runs of step 27's training step and step 16's
        decode step against the walls those phases measured."""
        from repro_torch.launch import roofline
        results = self.dry_run_results()
        walls = {"train": self.paths.get("train_step", {}).get("wall_s"),
                 "decode": (self.paths.get("serving", {})
                            .get("decode_step_ms", 0) / 1e3 or None)}
        self.check(all(walls.values()), f"walls not recorded: {walls}")
        self.paths["roofline"] = {}
        for key, r in results.items():
            if not key.endswith("_card"):
                continue
            row = roofline.analyze_artifact_np(r)
            wall = walls[r["kind"]]
            mfu = r["model_flops"] / r["devices"] / wall / \
                roofline.PEAK_FLOPS
            print(f"  {r['arch']} {r['kind']} B {r['global_batch']} x S "
                  f"{r['seq_len']} ({r['microbatches']} microbatches) on "
                  f"{self.smi}: compute {row['compute_s'] * 1e3:.3f} ms, "
                  f"memory {row['memory_s'] * 1e3:.3f} ms, collective "
                  f"{row['collective_s'] * 1e3:.3f} ms (bound "
                  f"{row['bound_s'] * 1e3:.3f} ms, {row['dominant']}); "
                  f"measured wall {wall * 1e3:.3f} ms = "
                  f"{wall / row['bound_s']:.2f} x the bound; model FLOPs "
                  f"{r['model_flops']:.4e}, MFU {100 * mfu:.2f}% of "
                  f"{roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s")
            self.paths["roofline"][r["kind"]] = dict(
                row, wall_s=wall, wall_over_bound=wall / row["bound_s"],
                mfu=mfu, card=self.smi)
            self.check(row["bound_s"] > 0 and mfu > 0
                       and wall >= row["bound_s"],
                       f"roofline of {key}: wall {wall} s against {row}")
        self.check(set(self.paths["roofline"]) == {"train", "decode"},
                   "a (1, 1) dry run is missing")

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
                 "src/repro/kernels/psdsf_vds/kernel.py:55", "float32"),
                ("flash_attention",
                 "src/repro_torch/kernels/csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention/kernel.py:74",
                 "bfloat16"),
                ("decode_attention",
                 "src/repro_torch/kernels/csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention/kernel.py:63",
                 "bfloat16"),
                ("ssd_scan", "src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:67", "bfloat16")):
            main = self.rows[(name, dtype)]
            by_path = {layout: path["launches"][name]
                       for layout, path in self.paths.items()
                       if "launches" in path}
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
            row.update({key: v for key, v in main.items() if key not in row})
            if name in KERNEL_BODIES:
                row["bodies"] = KERNEL_BODIES[name]
            if name == "flash_attention":
                # launches by body over the paths that count them
                row["launches_by_body"] = {
                    attr: sum(path["flash_bodies"].get(attr, 0)
                              for path in self.paths.values()
                              if "flash_bodies" in path)
                    for attr in BODY_COUNTS}
            # the other shapes and dtypes the phases measured
            # the windowed and float8 launches of the paths that made them
            for attr in VARIANT_COUNTS:
                counts = {p: path["variants"][f"{name}.{attr}"]
                          for p, path in self.paths.items()
                          if f"{name}.{attr}" in path.get("variants", {})}
                if any(counts.values()):
                    row[attr] = sum(counts.values())
                    row[f"{attr}_by_path"] = counts
            for variant, prefix in (("float32", "f32"), ("tdm", "tdm"),
                                    ("float32_ragged", "f32_ragged"),
                                    ("float32_s512", "f32_s512"),
                                    ("float32_s128", "f32_s128"),
                                    ("bfloat16_lse", "lse"),
                                    ("float32_lse", "f32_lse"),
                                    ("bfloat16_ragged", "ragged"),
                                    ("bfloat16_long", "long"),
                                    ("bfloat16_s512", "s512"),
                                    ("bfloat16_s128", "s128"),
                                    ("bfloat16_window", "window"),
                                    ("float32_window", "f32_window"),
                                    ("bfloat16_window_lse", "window_lse"),
                                    ("e4m3", "e4m3"), ("e5m2", "e5m2"),
                                    ("e4m3_window", "e4m3_window"),
                                    ("e5m2_window", "e5m2_window"),
                                    ("f32_bf16", "mixed"),
                                    ("f32_bf16_window", "mixed_window")):
                other = self.rows.get((name, variant))
                if other and variant != dtype:
                    row.update({f"{prefix}_{key}": v
                                for key, v in other.items()})
            # the MoE models' widths ("<variant>@<arch>")
            widths = {variant: other for (kname, variant), other
                      in self.rows.items() if kname == name and "@" in variant}
            if widths:
                row["widths"] = widths
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
    # the launch tooling's dry runs need no card: they run in the
    # background from here (CPU only, at the lowest priority) and are
    # collected after the cross-pod mean; every exit path stops them
    atexit.register(smoke.stop_dry_runs)
    smoke.start_dry_runs()
    smoke.phase("paper examples", smoke.paper)
    smoke.phase("psdsf_fill vs plain", smoke.fill_vs_plain)
    if "psdsf_fill vs plain" not in smoke.failed:
        smoke.phase("psdsf_fill_bucketed vs plain", smoke.bucketed_vs_plain)
        smoke.phase("psdsf_vds vs plain", smoke.vds_vs_plain)
        smoke.phase("main path", smoke.main_path)
        if not smoke.failed:
            smoke.phase("main path, sparse", smoke.sparse_path)
        smoke.phase("profile", smoke.profile)
        smoke.phase("churn path", smoke.churn_path)
        smoke.phase("tick path", smoke.tick_path)
        if "main path" not in smoke.failed:
            smoke.phase("batched re-solve", smoke.batched_path)
        smoke.phase("headroom path", smoke.headroom_path)
        smoke.phase("baseline path", smoke.baseline_path)
        smoke.phase("baseline churn", smoke.baseline_churn)
        smoke.phase("lexmm path", smoke.lexmm_path)
        smoke.phase("scheduler path", smoke.scheduler_path)
        # the sharing-property checkers at the pin, and Section IV's
        # gamma-direct solve on the co-processor scenario
        smoke.phase("properties", smoke.properties_path)
        smoke.phase("gamma-direct", smoke.gamma_path)
    smoke.phase("flash_attention vs plain", smoke.flash_vs_plain)
    smoke.phase("flash tile plans", smoke.flash_plans)
    smoke.phase("flash_attention vs plain, float32",
                lambda: smoke.flash_vs_plain(label="float32"))
    smoke.phase("decode_attention vs plain", smoke.decode_vs_plain)
    smoke.phase("decode chunk plans", smoke.decode_plans)
    smoke.phase("serving path", smoke.serving)
    if "serving path" not in smoke.failed:
        smoke.phase("serving profile", smoke.serving_profile)
    smoke.phase("serving path, kernel vs plain", smoke.serving_vs_plain)
    smoke.phase("ssd_scan vs plain", smoke.ssd_vs_plain)
    mamba = ("mamba2_1_3b", "serving_mamba2")
    smoke.phase("serving path, mamba2_1_3b", lambda: smoke.serving(*mamba))
    if "serving path, mamba2_1_3b" not in smoke.failed:
        smoke.phase("serving profile, mamba2_1_3b",
                    lambda: smoke.serving_profile(mamba[1]))
    smoke.phase("mamba2 serving, kernel vs plain", smoke.mamba_vs_plain)
    # the MoE models: the attention kernels at their widths, the MoE layer
    # alone, ssd_scan at jamba's chunk, then each model's serving path
    for arch in MOE_ARCHS:
        smoke.phase(f"flash_attention vs plain, {arch}",
                    lambda a=arch: smoke.flash_vs_plain(a))
        smoke.phase(f"decode_attention vs plain, {arch}",
                    lambda a=arch: smoke.decode_vs_plain(a))
    smoke.phase("moe layer, gather vs dense", smoke.moe_layer)
    smoke.phase("ssd_scan vs plain, jamba_v0_1_52b",
                lambda: smoke.ssd_vs_plain("jamba_v0_1_52b"))
    for arch, layers, vs_layers in MOE_SERVING:
        path = f"serving_{arch}"
        smoke.phase(f"serving path, {arch}",
                    lambda a=arch, n=layers, p=path: smoke.serving(a, p, n))
        if f"serving path, {arch}" not in smoke.failed:
            smoke.phase(f"serving profile, {arch}",
                        lambda p=path: smoke.serving_profile(p))
        smoke.phase(f"{arch} serving, kernel vs plain",
                    lambda a=arch, n=vs_layers: smoke.moe_vs_plain(a, n))
    # the dense and frontend configs: the attention kernels at their
    # widths, then each model's serving path, its 2-layer kernel-vs-plain
    # run and, for the stub frontends, a prefill through their embeddings
    for arch in DENSE_ARCHS:
        smoke.phase(f"flash_attention vs plain, {arch}",
                    lambda a=arch: smoke.flash_vs_plain(a))
        smoke.phase(f"decode_attention vs plain, {arch}",
                    lambda a=arch: smoke.decode_vs_plain(a))
    for arch, layers, requests, new_tokens in DENSE_SERVING:
        path = f"serving_{arch}"
        smoke.phase(f"serving path, {arch}",
                    lambda a=arch, n=layers, p=path, r=requests,
                    t=new_tokens: smoke.serving(a, p, n, r, t))
        if f"serving path, {arch}" not in smoke.failed:
            smoke.phase(f"serving profile, {arch}",
                        lambda p=path: smoke.serving_profile(
                            p, *DENSE_PROFILE_WINDOW))
        smoke.phase(f"{arch} serving, kernel vs plain",
                    lambda a=arch: smoke.serving_vs_plain(a))
        if smoke.llm_config(arch=arch).frontend != "none":
            smoke.phase(f"frontend stub, {arch}",
                        lambda a=arch: smoke.frontend_stub(a))
    # sliding windows and float8 KV caches: the two attention kernels'
    # new variants, then qwen3_1_7b served with a window and an e4m3 cache
    smoke.phase("flash_attention vs plain, sliding window",
                smoke.flash_window_vs_plain)
    smoke.phase("decode_attention vs plain, float8 cache and window",
                smoke.decode_fp8_vs_plain)
    window = ("serving path, qwen3_1_7b, sliding window and float8 cache",
              "serving_window_fp8", smoke.window_opts())
    smoke.phase(window[0], lambda: smoke.serving(path=window[1],
                                                 opts=window[2]))
    if window[0] not in smoke.failed:
        smoke.phase(f"serving profile, {window[1]}",
                    lambda: smoke.serving_profile(window[1]))
    smoke.phase(f"{window[1]} serving, kernel vs plain",
                lambda: smoke.serving_vs_plain(opts=window[2],
                                               key=f"{window[1]}_vs_plain"))
    # params and activations in different dtypes: the decode kernel's
    # float32-query, bfloat16-cache entry, then qwen3_1_7b served with
    # float32 params over bfloat16 activations
    smoke.phase("decode_attention vs plain, float32 query over a bfloat16 "
                "cache", smoke.decode_mixed_vs_plain)
    split = ("serving path, qwen3_1_7b, float32 params over bfloat16 "
             "activations", "serving_split")
    smoke.phase(split[0], lambda: smoke.serving(path=split[1],
                                                opts=SPLIT_DTYPES))
    if split[0] not in smoke.failed:
        smoke.phase(f"serving profile, {split[1]}",
                    lambda: smoke.serving_profile(split[1]))
    smoke.phase(f"{split[1]} serving, kernel vs plain",
                lambda: smoke.serving_vs_plain(opts=SPLIT_DTYPES,
                                               key=f"{split[1]}_vs_plain"))
    # the training step: flash's lse output, the 2-layer float32 steps
    # kernels vs plain, then one full-width qwen3_1_7b step; the same with
    # a sliding window
    smoke.phase("flash_attention lse vs plain", smoke.flash_lse_vs_plain)
    for arch in ("qwen3_1_7b", "mamba2_1_3b"):
        smoke.phase(f"training, kernel vs plain, {arch}",
                    lambda a=arch: smoke.train_vs_plain(a))
    smoke.phase("training step", smoke.train_step)
    smoke.phase("training, kernel vs plain, sliding window",
                lambda: smoke.train_vs_plain("qwen3_1_7b", TRAIN_WINDOW))
    smoke.phase("training step, sliding window", smoke.train_step_window)
    smoke.phase("training step, float32 params over bfloat16 activations",
                smoke.train_step_split)
    smoke.phase("training, kernel vs plain, float32 params over bfloat16 "
                "activations", lambda: smoke.train_vs_plain(
                    "qwen3_1_7b", dtypes=SPLIT_DTYPES))
    smoke.phase("training step, remat dots", smoke.train_step_remat)
    # the training loop (checkpoint, restart) and the elastic re-solve of
    # the scheduler's fleet after pod failures
    smoke.phase("training loop", smoke.train_loop)
    smoke.phase("elastic re-solve", smoke.elastic_resolve)
    # the launch tooling: the cross-pod mean, then the dry runs' results
    try:
        smoke.phase("headdim decode", smoke.headdim_decode)
        smoke.phase("pod mean", smoke.pod_mean)
        smoke.phase("launch dry run", smoke.launch_dry_run)
        smoke.phase("roofline on the card", smoke.roofline_card)
    finally:
        smoke.stop_dry_runs()
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
