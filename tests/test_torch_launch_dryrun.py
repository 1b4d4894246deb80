"""The port's dry run, collective accounting and H100 roofline
(``repro_torch.launch.dryrun``, ``launch.collectives``,
``launch.roofline``), on torch's fake process group, with no device.

  * ``lower_cell_torch`` on a fake 8-rank (2, 4) ("data", "model") mesh
    for the smoke configs of qwen3_1_7b, granite_moe_3b_a800m and
    jamba_v0_1_52b, train (two microbatches, remat) and decode: ``ok``;
    per-device argument bytes equal the sharded state's (params, AdamW
    state and batch, or params, caches, token and position, each shard by
    ``launch.sharding``'s specs); at least one collective; per-device
    FLOPs between 1/8 of and all of the same step's FLOPs on one device.
  * The one-device FLOPs, a (1, 1) mesh of a one-rank group, equal
    ``torch.utils.flop_counter.FlopCounterMode`` of the unsharded step on
    real CPU tensors within 1%, and for qwen3_1_7b a closed form: matrix
    products 8 FLOPs a param and token in train (forward, the remat
    recompute, backward; the unembedding, and the MLP's output product,
    which the recompute does not reach, 6), 2 in decode; attention: in
    train the plain ``_attend`` (the smoke config sets no flash block)
    over every (q, k) pair, 16 B S^2 H D a layer (4 forward, twice, and 8
    backward); in decode the decode kernel's 4 B S_max H D over the whole
    cache (a trace cannot read the lengths).
  * One run on the fake (16, 16) production mesh at smoke depth.
  * The decode cell with ``decode_cache_shard="headdim"`` on a (2, 2)
    mesh (qwen3_1_7b's smoke config, batch 64, a 64-row cache): one
    all-reduce of the (B/2, Hq, S_max) float32 scores a layer over
    "model", no all-gather of a cache-sized tensor, one head-dim region a
    layer; a cache sharded on its kv heads, or on its sequence and head
    dim at once, is refused.
  * The ring factors equal the reference's ``hlo._wire_bytes``; a DTensor
    product of Shard(1) by Shard(0) counts one all-reduce of the result's
    bytes; a group that spans 8-GPU nodes is counted as such; an indexed
    read or write counts its rows, a metadata query or a reshape
    nothing.
  * ``analyze_artifact_np`` on a fixed artifact gives the hand-computed
    terms with the H100 constants and the node-crossing rule; the CLI
    writes a result the roofline CLI reads.
  * The kernels' plain versions run as one operator each on CPU tensors:
    equal to ``ref.py`` bit for bit, and traced as the kernel's inputs,
    outputs and FLOP count (no intermediate), so a long prefill's peak
    holds no S x S score matrix.

Every test leaves no default process group behind."""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch import hlo
from repro_torch.configs import ShapeSpec, get_smoke_config
from repro_torch.launch import collectives as col
from repro_torch.launch import dryrun, roofline
from repro_torch.launch import sharding as sh

ARCHS = ("qwen3_1_7b", "granite_moe_3b_a800m", "jamba_v0_1_52b")
TRAIN = ShapeSpec("smoke_train", "train", 32, 8)
DECODE = ShapeSpec("smoke_decode", "decode", 64, 16)
MESH = (2, 4)


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


def _cell(arch, shape, mesh_shape, microbatches=2):
    return dryrun.lower_cell_torch(
        arch, shape.name, microbatches=microbatches, mesh_shape=mesh_shape,
        shape=shape, smoke=True)


def _expected_argument_bytes(arch, shape):
    """Per-device bytes of the sharded state and inputs, from the specs."""
    from repro_torch.launch.specs import input_specs_torch
    from repro_torch.models.model import abstract_params_torch
    axes = sh.MeshAxes(MESH, ("data", "model"))
    cfg = get_smoke_config(arch)
    named = dict(abstract_params_torch(cfg).named_parameters())
    pspec = sh.sanitize_specs_np(sh.param_specs_np(cfg, axes), named, axes)

    def local(spec, t):
        return int(np.prod(sh.local_shape_np(spec, t.shape, axes))) * \
            t.element_size()
    params = sum(local(pspec[n], t) for n, t in named.items())
    inputs = input_specs_torch(cfg, shape)
    if shape.kind == "train":
        bspec = sh.sanitize_specs_np(sh.batch_specs_np(cfg, axes, "train"),
                                     inputs["batch"], axes)
        batch = sum(local(bspec[k], t) for k, t in inputs["batch"].items())
        moments = 2 * sum(local(pspec[n], t.float())
                          for n, t in named.items())
        return params + moments + 8 + batch
    cspec = sh.sanitize_specs_np(
        sh.cache_specs_np(cfg, axes, shape.global_batch), inputs["caches"],
        axes)
    caches = sum(local(s[k], t) for c, s in zip(inputs["caches"], cspec)
                 for k, t in c.items())
    tspec = sh.sanitize_specs_np(sh.token_specs_np(axes, shape.global_batch),
                                 inputs["token"], axes)
    return params + caches + local(tspec, inputs["token"]) + 4


def _flop_counter_step(arch, shape, microbatches=2):
    """FlopCounterMode's total for the unsharded step on real CPU
    tensors."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models.model import (forward_decode, init_caches,
                                          init_params)
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.step import (build_train_step_torch,
                                        make_train_state_torch)
    cfg = get_smoke_config(arch)
    model = init_params(cfg, device="cpu")
    tok = torch.zeros((shape.global_batch, shape.seq_len), dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            oc = OptimizerConfig()
            state = make_train_state_torch(cfg, model, oc, device="cpu")
            build_train_step_torch(cfg, oc, microbatches, device="cpu")(
                state, {"tokens": tok, "labels": tok})
        else:
            caches = init_caches(cfg, shape.global_batch, shape.seq_len,
                                 device="cpu")
            forward_decode(cfg, model, caches, tok[:, 0], 0, device="cpu")
    return fc.get_total_flops()


@pytest.fixture(scope="module")
def one_device():
    return {(arch, shape.kind): _cell(arch, shape, (1, 1))
            for arch in ARCHS for shape in (TRAIN, DECODE)}


@pytest.mark.parametrize("shape", [TRAIN, DECODE], ids=["train", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_on_an_eight_rank_mesh(one_device, arch, shape):
    res = _cell(arch, shape, MESH)
    assert res["ok"] and res["devices"] == 8
    assert res["mesh_shape"] == {"shape": [2, 4], "axes": ["data", "model"]}
    mem = res["memory_analysis"]
    assert mem["argument_size_in_bytes"] == _expected_argument_bytes(arch,
                                                                     shape)
    assert mem["temp_size_in_bytes"] > 0
    assert sum(c["count"] for c in res["collectives"].values()) >= 1
    assert res["local_regions"], "no kernel region was traced"
    total = one_device[(arch, shape.kind)]["cost_analysis"]["flops"]
    flops = res["cost_analysis"]["flops"]
    assert total / 8 <= flops <= total, (flops, total)
    assert res["cost_analysis"]["bytes accessed"] > 0
    json.dumps(res)


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_one_device_flops_equal_flop_counter(one_device, arch, kind):
    res = one_device[(arch, kind)]
    want = _flop_counter_step(arch, TRAIN if kind == "train" else DECODE)
    got = res["cost_analysis"]["flops"]
    assert abs(got - want) <= 0.01 * want, (got, want)
    # no collective moves a byte on one device
    assert all(c["wire_bytes"] == 0 for c in res["collectives"].values())


def test_qwen3_flops_equal_closed_form(one_device):
    cfg = get_smoke_config("qwen3_1_7b")
    d, hd = cfg.d_model, cfg.head_dim
    layer = (d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
             + 3 * d * cfg.d_ff)
    unembed = d * cfg.vocab_padded
    b, s = TRAIN.global_batch, TRAIN.seq_len
    t = b * s
    # the recompute stops once the saved tensors are back (non-reentrant
    # checkpoint), so the group's last product, the MLP's wo, runs twice
    wo = cfg.d_ff * d
    train = ((8 * layer - 2 * wo) * t * cfg.num_layers + 6 * t * unembed
             + 16 * b * s * s * cfg.num_heads * hd * cfg.num_layers)
    got = one_device[("qwen3_1_7b", "train")]["cost_analysis"]["flops"]
    assert abs(got - train) <= 0.01 * train, (got, train)
    b, s_max = DECODE.global_batch, DECODE.seq_len
    decode = (2 * b * (layer * cfg.num_layers + unembed)
              + 4 * b * s_max * cfg.num_heads * hd * cfg.num_layers)
    got = one_device[("qwen3_1_7b", "decode")]["cost_analysis"]["flops"]
    assert abs(got - decode) <= 0.01 * decode, (got, decode)


def test_dry_run_on_the_production_mesh_at_smoke_depth():
    res = dryrun.lower_cell_torch("qwen3_1_7b", "smoke_decode",
                                  shape=ShapeSpec("smoke_decode", "decode",
                                                  64, 32), smoke=True)
    assert res["ok"] and res["devices"] == 256 and res["mesh"] == "single"
    assert res["mesh_shape"]["shape"] == [16, 16]
    sizes = {s for c in res["collectives"].values()
             for s in c["by_group_size"]}
    assert "16" in sizes
    # the 16-way model axis spans two 8-GPU nodes, the data axis sixteen
    assert sum(c["wire_bytes_internode"]
               for c in res["collectives"].values()) > 0


def test_headdim_decode_sums_scores_over_the_model_axis(monkeypatch):
    model_groups, log = [], []
    make_mesh = dryrun._mesh_torch

    def mesh_spy(*a):
        mesh = make_mesh(*a)
        model_groups.append(mesh.get_group("model").group_name)
        return mesh
    dispatch = col.TraceRecorder.__torch_dispatch__

    def dispatch_spy(self, func, types, args=(), kwargs=None):
        out = dispatch(self, func, types, args, kwargs)
        name = func.overloadpacket.__name__
        if out is not NotImplemented and not col.TraceRecorder.paused \
                and func.namespace in col._NAMESPACES and name in col._KIND:
            log.append((col._KIND[name], sum(col._nbytes_torch(t) for t in
                                             col._tensors_torch(out)),
                        args[2]))
        return out
    monkeypatch.setattr(dryrun, "_mesh_torch", mesh_spy)
    monkeypatch.setattr(col.TraceRecorder, "__torch_dispatch__",
                        dispatch_spy)
    b, s_max = 64, 64
    res = dryrun.lower_cell_torch(
        "qwen3_1_7b", "headdim_decode",
        opts=sh.ShardingOptions(decode_cache_shard="headdim"),
        mesh_shape=(2, 2), shape=ShapeSpec("headdim_decode", "decode",
                                           s_max, b), smoke=True)
    cfg = get_smoke_config("qwen3_1_7b")
    assert res["ok"] and res["sharding_options"]["decode_cache_shard"] == \
        "headdim"
    assert res["local_regions"]["decode_attention (head-dim shards)"] == \
        cfg.num_layers
    scores = (b // 2) * cfg.num_heads * s_max * 4
    summed = [g for kind, nbytes, g in log
              if kind == "all-reduce" and nbytes == scores]
    assert summed == model_groups * cfg.num_layers
    cache = (b // 2) * s_max * cfg.num_kv_heads * cfg.head_dim * 4
    gathers = [nbytes for kind, nbytes, _ in log if kind == "all-gather"]
    assert gathers and max(gathers) < cache


def test_decode_refuses_a_heads_sharded_cache():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.models.attention import _cache_axes_torch
    with dryrun.fake_process_group_torch(4):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        local = torch.zeros((2, 8, 2, 4))
        for placements, match in (((Shard(0), Shard(2)), "kv heads"),
                                  ((Shard(1), Shard(3)), "both its")):
            with pytest.raises(NotImplementedError, match=match):
                _cache_axes_torch(DTensor.from_local(local, mesh, placements,
                                                     run_check=False))
        assert _cache_axes_torch(DTensor.from_local(
            local, mesh, (Shard(0), Shard(3)), run_check=False)) == \
            (("data",), (), ("model",))


@pytest.mark.parametrize("s", [1, 2, 16, 256])
@pytest.mark.parametrize("kind", col.COLLECTIVES)
def test_wire_factors_equal_reference(kind, s):
    assert col.wire_bytes_np(kind, 4096, s) == hlo._wire_bytes(kind, 4096, s)


@pytest.mark.parametrize("world, internode", [(4, False), (16, True)])
def test_a_sharded_product_counts_one_all_reduce(world, internode):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with dryrun.fake_process_group_torch(world):
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
        a = distribute_tensor(torch.ones(8, 4 * world), mesh, [Shard(1)],
                              src_data_rank=None)
        b = distribute_tensor(torch.ones(4 * world, 4), mesh, [Shard(0)],
                              src_data_rank=None)
        rec = col.TraceRecorder()
        with rec:
            (a @ b).redistribute(mesh, [Replicate()])
    got = rec.collective_summary()
    assert got["all-reduce"]["count"] == 1
    assert got["all-reduce"]["bytes"] == 8 * 4 * 4
    assert got["all-reduce"]["wire_bytes"] == 2.0 * 128 * (world - 1) / world
    assert got["all-reduce"]["by_group_size"] == {str(world): 1}
    assert (got["all-reduce"]["wire_bytes_internode"] > 0) == internode
    assert sum(c["count"] for k, c in got.items() if k != "all-reduce") == 0
    assert rec.flops == 2 * 8 * 4 * 4


def test_recorder_counts_indexed_rows_and_no_metadata():
    # a lookup and a row write move their rows and indices, not the whole
    # table; a reshape and a device query move nothing
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        table = torch.empty(1000, 64)
        idx = torch.zeros(8, dtype=torch.long)
        rec = col.TraceRecorder()
        with rec:
            rows = table[idx]
            table[idx] = rows
            _ = rows.device
            flat = (rows @ torch.empty(64, 2)).reshape(16)
    row_bytes, idx_bytes = 8 * 64 * 4, 8 * 8
    product = (8 * 64 + 64 * 2 + 8 * 2) * 4
    assert rec.bytes_accessed == (2 * row_bytes + idx_bytes) * 2 + product
    assert flat.shape == (16,)
    assert rec.ops["aten.index_put_"][0] == row_bytes


def test_roofline_terms_with_the_h100_constants():
    art = {"arch": "a", "shape": "s", "mesh": "single", "kind": "train",
           "devices": 256, "model_flops": 0.5 * 989e12 * 256,
           "cost_analysis": {"flops": 989e12, "bytes accessed": 6.7e12},
           "memory_analysis": {"argument_size_in_bytes": 10**9,
                               "output_size_in_bytes": 0,
                               "temp_size_in_bytes": 2 * 10**9},
           "collectives": {
               "all-gather": {"wire_bytes": 600e9,
                              "wire_bytes_internode": 150e9},
               "all-reduce": {"wire_bytes": 0.0,
                              "wire_bytes_internode": 0.0}}}
    row = roofline.analyze_artifact_np(art)
    assert row["compute_s"] == pytest.approx(1.0)
    assert row["memory_s"] == pytest.approx(2.0)
    # 450 GB inside a node over NVLink (1 s), 150 GB across nodes over
    # 50 GB/s InfiniBand (3 s)
    assert row["collective_s"] == pytest.approx(4.0)
    assert row["dominant"] == "collective" and row["bound_s"] == \
        pytest.approx(4.0)
    assert row["roofline_fraction"] == pytest.approx(0.25)
    assert row["mfu_at_roofline"] == pytest.approx(0.125)
    assert row["useful_ratio"] == pytest.approx(0.5)
    assert row["hbm_gb_per_dev"] == pytest.approx(3.0)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.NVLINK_BW,
            roofline.NETWORK_BW) == (989e12, 3.35e12, 450e9, 50e9)


def test_cli_writes_a_cell_the_roofline_reads(tmp_path, capsys):
    out = dryrun.main(["--arch", "qwen3_1_7b", "--shape", "decode_32k",
                       "--out", str(tmp_path)])
    assert len(out) == 1 and out[0]["ok"], out
    art = json.loads((tmp_path / "qwen3_1_7b_decode_32k_single.json")
                     .read_text())
    assert art["devices"] == 256 and art["layers"] == 28
    rows = roofline.main(["--dir", str(tmp_path)])
    assert len(rows) == 1 and rows[0]["arch"] == "qwen3_1_7b"
    assert "qwen3_1_7b" in capsys.readouterr().out


def _flash_inputs(b, s, hq, hkv, d):
    g = torch.Generator().manual_seed(s)
    return [torch.randn(b, s, h, d, generator=g) for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b, s, hq, hkv, d", [(2, 64, 4, 2, 16),
                                              (1, 33, 6, 2, 8)])
def test_flash_plain_operator(b, s, hq, hkv, d, causal):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.flash_attention import kernel, ref
    q, k, v = _flash_inputs(b, s, hq, hkv, d)
    out, lse = kernel.flash_attention(q, k, v, causal=causal,
                                      return_lse=True)
    want, want_lse = ref.flash_attention(q, k, v, causal=causal,
                                         return_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    with FakeTensorMode() as mode:
        fq, fk, fv = (mode.from_tensor(t) for t in (q, k, v))
        rec = col.TraceRecorder()
        with rec:
            fo, fl = kernel.flash_attention(fq, fk, fv, causal=causal,
                                            return_lse=True)
    assert fo.shape == out.shape and fl.shape == lse.shape
    assert dict(rec.ops) == {"repro_torch.flash_attention_plain": [
        (out.numel() + lse.numel()) * 4, 1, rec.flops]}
    pairs = s * (s + 1) // 2 if causal else s * s
    assert rec.flops == 4 * b * hq * d * pairs
    assert rec.bytes_accessed == 4 * (q.numel() + k.numel() + v.numel()
                                      + out.numel() + lse.numel())


def test_decode_plain_operator():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.decode_attention import kernel, ref
    g = torch.Generator().manual_seed(3)
    q = torch.randn(3, 8, 16, generator=g)
    kc, vc = (torch.randn(3, 40, 2, 16, generator=g) for _ in range(2))
    kv_len = torch.tensor([0, 7, 40], dtype=torch.int32)
    out, lse = kernel.decode_attention(q, kc, vc, kv_len, return_lse=True)
    want, want_lse = ref.decode_attention(q, kc, vc, kv_len,
                                          return_lse=True)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert torch.equal(kernel.decode_attention(q, kc, vc, kv_len), want)
    assert torch.isneginf(lse[0]).all() and not out[0].any()
    with FakeTensorMode() as mode:
        args = [mode.from_tensor(t) for t in (q, kc, vc, kv_len)]
        rec = col.TraceRecorder()
        with rec:
            fo = kernel.decode_attention(*args)
    assert fo.shape == out.shape
    assert list(rec.ops) == ["repro_torch.decode_attention_plain"]
    assert rec.flops == 4 * 3 * 8 * 16 * 40
    assert rec.bytes_accessed == 4 * (q.numel() + kc.numel() + vc.numel()
                                      + kv_len.numel() + out.numel())


def test_ssd_plain_operator():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.ssd_scan import kernel, ref
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 3, 20, 4, generator=g)
    dt = torch.rand(2, 3, 20, generator=g)
    a = -torch.rand(3, generator=g)
    bm, cm = (torch.randn(2, 20, 5, generator=g) for _ in range(2))
    init = torch.randn(2, 3, 4, 5, generator=g)
    out = torch.empty(2, 20, 3, 4).transpose(1, 2)
    y, state = kernel.ssd_scan(x, dt, a, bm, cm, chunk=16, init_state=init,
                               out=out)
    want, want_state = ref.ssd_scan(x, dt, a, bm, cm, chunk=16,
                                    init_state=init)
    assert y is out
    assert torch.equal(y, want) and torch.equal(state, want_state)
    with FakeTensorMode() as mode:
        args = [mode.from_tensor(t) for t in (x, dt, a, bm, cm)]
        rec = col.TraceRecorder()
        with rec:
            fy, fs = kernel.ssd_scan(*args, chunk=16)
    assert fy.shape == y.shape and fs.shape == state.shape
    assert list(rec.ops) == ["aten.empty",
                             "repro_torch.ssd_scan_plain"]
    # chunks of 16 and 4 rows (module docstring of the kernel's wrapper)
    per_chunk = [c * (c + 1) * 5 + 3 * (c * (c + 1) * 4 + 4 * c * 5 * 4)
                 for c in (16, 4)]
    assert rec.flops == 2 * sum(per_chunk)


def test_long_prefill_holds_no_score_matrix():
    # the trace sees the flash kernel's inputs and outputs, not the plain
    # version's scores: at 8,192 rows the peak stays below one (S x S)
    # float32 score matrix of the one head each device holds
    s = 8192
    res = dryrun.lower_cell_torch(
        "qwen3_1_7b", "long_prefill", mesh_shape=MESH,
        shape=ShapeSpec("long_prefill", "prefill", s, 2), smoke=True)
    assert res["ok"]
    assert res["memory_analysis"]["temp_size_in_bytes"] < s * s * 4
