"""The port's int8 error-feedback compression
(``repro_torch.train.compression``) against the reference's
(``repro.train.compression``, jitted) on the same float32 inputs from a
numpy seed: ``q`` and ``scale`` bit for bit at sizes around the 1,024-value
block, and twenty error-feedback rounds equal, estimate and residual; then
the reference's own two compression tests on the port; and
``compressed_cross_pod_mean_torch`` on 4 gloo CPU ranks against the
reference's ``compressed_cross_pod_mean`` under ``jax.vmap`` over a "pod"
axis (residuals bit for bit, the mean within 4 ulp)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as ref
from repro_torch.configs import get_smoke_config
from repro_torch.models.model import init_params
from repro_torch.train import compression

SHAPES = [(1,), (1023,), (1024,), (1025,), (3, 700)]


def _normal(shape, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_quantize_equals_reference(shape):
    x = _normal(shape, seed=sum(shape))
    q_ref, s_ref, meta_ref = jax.jit(
        lambda a: ref.quantize_int8(a)[:2])(x) + (None,)
    q, s, meta = compression.quantize_int8_torch(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert meta == (shape, x.size)
    back = compression.dequantize_int8_torch(q, s, meta)
    want = ref.dequantize_int8(jnp.asarray(q_ref), jnp.asarray(s_ref),
                               (shape, x.size))
    assert back.shape == shape
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))


def test_quantize_bfloat16_input_equals_reference():
    x = _normal((2, 600), seed=3)
    xb = torch.from_numpy(x).bfloat16()
    q, s, _ = compression.quantize_int8_torch(xb)
    q_ref, s_ref, _ = ref.quantize_int8(jnp.asarray(xb.float().numpy())
                                        .astype(jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))


def test_zero_block_takes_the_scale_floor():
    q, s, meta = compression.quantize_int8_torch(torch.zeros(1500))
    assert torch.all(q == 0) and torch.all(s == 1e-12)
    assert torch.all(compression.dequantize_int8_torch(q, s, meta) == 0)


def test_twenty_error_feedback_rounds_equal_reference():
    # the reference op by op, as its own tests call it: the jitted round
    # contracts ``target - q * scale`` into a fused multiply-add (next test)
    residual = jnp.zeros((5, 300), jnp.float32)
    t_residual = torch.zeros(5, 300)
    for i in range(20):
        g = _normal((5, 300), seed=100 + i, scale=1.0)
        est, residual = ref.ef_compress_decompress(jnp.asarray(g), residual)
        t_est, t_residual = compression.ef_compress_decompress_torch(
            torch.from_numpy(g), t_residual)
        np.testing.assert_array_equal(t_est.numpy(), np.asarray(est))
        np.testing.assert_array_equal(t_residual.numpy(),
                                      np.asarray(residual))


def test_error_feedback_round_against_jitted_reference():
    # jitted, XLA fuses the residual's product and subtraction (one
    # rounding, not two): the estimate is equal, the residual within one
    # float32 ulp of the target it is taken from
    g = _normal((5, 300), seed=100, scale=1.0)
    r = _normal((5, 300), seed=99, scale=0.01)
    est, residual = jax.jit(ref.ef_compress_decompress)(jnp.asarray(g),
                                                        jnp.asarray(r))
    t_est, t_residual = compression.ef_compress_decompress_torch(
        torch.from_numpy(g), torch.from_numpy(r))
    np.testing.assert_array_equal(t_est.numpy(), np.asarray(est))
    ulp = np.spacing(np.abs(g + r)).astype(np.float64)
    err = np.abs(t_residual.numpy().astype(np.float64)
                 - np.asarray(residual, np.float64))
    assert np.all(err <= ulp), float((err / ulp).max())


def test_quantize_roundtrip_error_bounded():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(333, generator=g) * 3.0
    q, s, meta = compression.quantize_int8_torch(x)
    err = (compression.dequantize_int8_torch(q, s, meta) - x).abs()
    # per-block max-scale symmetric quant: err <= scale/2 per block
    assert float(err.max()) <= float(s.max()) / 2 + 1e-6


def test_error_feedback_unbiased_over_time():
    """EF: the accumulated transmitted signal tracks the true gradient sum
    (residual stays bounded)."""
    g = torch.Generator().manual_seed(1)
    residual = torch.zeros(256)
    total_true = torch.zeros(256)
    total_sent = torch.zeros(256)
    for _ in range(50):
        grad = torch.randn(256, generator=g)
        est, residual = compression.ef_compress_decompress_torch(grad,
                                                                 residual)
        total_true += grad
        total_sent += est
    drift = float((total_sent + residual - total_true).abs().max())
    assert drift < 1e-3, drift
    assert float(residual.abs().max()) < 1.0


def test_init_residuals_and_wire_ratio():
    cfg = get_smoke_config("qwen3_1_7b")
    model = init_params(cfg, device="cpu")
    res = compression.init_residuals_torch(model)
    named = dict(model.named_parameters())
    assert res.keys() == named.keys()
    for name, r in res.items():
        assert r.dtype == torch.float32 and r.shape == named[name].shape
        assert not r.any()
    assert compression.init_residuals_torch(named).keys() == res.keys()
    assert compression.wire_bytes_ratio_np() == ref.wire_bytes_ratio()
    assert compression.BLOCK == ref.BLOCK


# -- the cross-pod mean over a process group ---------------------------------

POD_SHAPES = {"w": (4, 256), "b": (1023,), "m": (3, 700)}
PODS = 4

POD_BODY = """
import numpy as np
from repro_torch.train.compression import compressed_cross_pod_mean_torch
data = np.load("pods.npz")
names = sorted({k.split("/", 1)[1] for k in data.files})
grads = {n: torch.from_numpy(data[f"g/{n}"][RANK]) for n in names}
res = {n: torch.from_numpy(data[f"r/{n}"][RANK]) for n in names}
mean, new_res = compressed_cross_pod_mean_torch(grads, res)
torch.save({"mean": mean, "res": new_res}, f"pod_{RANK}.pt")
"""


def _pod_inputs():
    grads = {n: _normal((PODS,) + s, seed=200 + i, scale=1.0)
             for i, (n, s) in enumerate(sorted(POD_SHAPES.items()))}
    res = {n: _normal((PODS,) + s, seed=300 + i, scale=0.01)
           for i, (n, s) in enumerate(sorted(POD_SHAPES.items()))}
    return grads, res


@pytest.fixture(scope="module")
def pod_means(tmp_path_factory):
    from torch_gloo import run_gloo_ranks
    tmp = tmp_path_factory.mktemp("pods")
    grads, res = _pod_inputs()
    np.savez(tmp / "pods.npz", **{f"g/{n}": v for n, v in grads.items()},
             **{f"r/{n}": v for n, v in res.items()})
    run_gloo_ranks(tmp, POD_BODY, world=PODS, timeout=120)
    got = [torch.load(tmp / f"pod_{r}.pt") for r in range(PODS)]
    # the reference's shard_map body under vmap over a "pod" axis (psum
    # works there, no forced devices); not jitted, so nothing fuses
    want_mean, want_res = jax.vmap(
        lambda g, r: ref.compressed_cross_pod_mean(g, r, "pod"),
        axis_name="pod")({n: jnp.asarray(v) for n, v in grads.items()},
                         {n: jnp.asarray(v) for n, v in res.items()})
    return got, want_mean, want_res, grads


def test_cross_pod_mean_residuals_equal_reference(pod_means):
    got, _, want_res, _ = pod_means
    for r in range(PODS):
        assert got[r]["res"].keys() == want_res.keys()
        for n, w in want_res.items():
            np.testing.assert_array_equal(got[r]["res"][n].numpy(),
                                          np.asarray(w)[r])


def test_cross_pod_mean_within_four_ulp_of_reference(pod_means):
    # the ring's summation order may differ from XLA's: 4 ulp of max|mean|
    got, want_mean, _, _ = pod_means
    for n, w in want_mean.items():
        w = np.asarray(w)
        ulp = float(np.spacing(np.float32(np.abs(w).max())))
        for r in range(PODS):
            assert got[r]["mean"][n].dtype == torch.float32
            np.testing.assert_array_equal(got[r]["mean"][n].numpy(),
                                          got[0]["mean"][n].numpy())
            err = float(np.abs(got[r]["mean"][n].numpy() - w[r]).max())
            assert err <= 4 * ulp, (n, r, err, ulp)


def test_cross_pod_mean_within_the_references_bound_of_the_exact_mean(
        pod_means):
    # one int8 EF round: error bounded by the quantization step (~1/127),
    # the bound of tests/test_compressed_psum.py, against the exact mean of
    # what each pod sends, gradient plus residual
    got, _, _, grads = pod_means
    _, res = _pod_inputs()
    for n, g in grads.items():
        exact = (g.astype(np.float64) + res[n]).mean(axis=0)
        err = float(np.abs(got[0]["mean"][n].numpy() - exact).max())
        assert err / float(np.abs(exact).max()) < 1.5 / 127, n


def test_cross_pod_mean_needs_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        compression.compressed_cross_pod_mean_torch(
            {"w": torch.ones(4)}, {"w": torch.zeros(4)})
