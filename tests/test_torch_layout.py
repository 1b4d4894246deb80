"""The port's ``BucketedLayout`` and ``resolve_layout`` against the JAX
package's ``repro.core.layout`` on the same supports: every array, every
derived quantity and every transport must be identical (numpy on both
sides, so the bound is equality)."""
import numpy as np
import pytest

from repro.core import gamma_matrix as jax_gamma_matrix
from repro.core import instances as jax_instances
from repro.core.layout import BucketedLayout as RefLayout
from repro.core.layout import resolve_layout as ref_resolve
from repro_torch.core import layout as port_layout
from repro_torch.core.instances import sparse_cell_instance
from repro_torch.core.layout import BucketedLayout, resolve_layout


def _supports():
    rng = np.random.default_rng(3)
    empty_col = rng.random((40, 9)) < 0.3
    empty_col[:, 4] = False                        # a server nobody fits
    empty_col[7, :] = False                        # a user who fits nowhere
    single = np.zeros((6, 4), dtype=bool)
    single[[0, 2], 0] = True
    single[1, 1] = True
    single[2, [1, 3]] = True
    return {
        "random20": rng.random((60, 12)) < 0.2,
        "random_dense": rng.random((30, 5)) < 0.9,
        "degenerate": empty_col,
        "single_homed": single,
        "all_ones": np.ones((20, 6), dtype=bool),
        "all_zeros": np.zeros((4, 3), dtype=bool),
        "one_user": np.array([[True, False, True]]),
        "gamma_float": jax_gamma_matrix(jax_instances.fig2_instance()),
    }


SUPPORTS = _supports()


@pytest.mark.parametrize("name", sorted(SUPPORTS))
def test_layout_arrays_equal_reference(name):
    supp = SUPPORTS[name]
    got, want = BucketedLayout.from_support(supp), RefLayout.from_support(supp)
    for field in ("indices", "mask", "counts", "user_ptr", "user_servers"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    for prop in ("num_users", "num_servers", "bucket_max", "nnz", "density"):
        assert getattr(got, prop) == getattr(want, prop), prop
    for a, b in zip(got.bucket_lists(), want.bucket_lists()):
        np.testing.assert_array_equal(a, b)
    for i in range(got.num_servers):
        np.testing.assert_array_equal(got.bucket_users(i),
                                      want.bucket_users(i))
        # padded slots hold distinct user ids: scatters never collide
        assert len(set(got.indices[i].tolist())) == got.bucket_max \
            or got.num_users < got.bucket_max


@pytest.mark.parametrize("name", sorted(SUPPORTS))
def test_transport_and_servers_of_equal_reference(name):
    supp = SUPPORTS[name]
    got, want = BucketedLayout.from_support(supp), RefLayout.from_support(supp)
    rng = np.random.default_rng(5)
    n, k = np.asarray(supp).shape
    x = rng.uniform(0.0, 5.0, (n, k))
    np.testing.assert_array_equal(got.gather(x), want.gather(x))
    xb = rng.uniform(0.0, 5.0, got.indices.shape)
    np.testing.assert_array_equal(got.scatter(xb), want.scatter(xb))
    on_support = x * (np.asarray(supp) > 0)
    np.testing.assert_array_equal(got.scatter(got.gather(on_support)),
                                  on_support)
    for users in (np.arange(n), np.array([0]), np.array([n - 1, 0, n - 1]),
                  np.array([], dtype=int)):
        np.testing.assert_array_equal(got.servers_of(users),
                                      want.servers_of(users))


def test_from_problem_equals_reference():
    prob, _ = jax_instances.sparse_cell_instance(num_users=300,
                                                 num_servers=32, cells=4)
    port_prob, _ = sparse_cell_instance(num_users=300, num_servers=32,
                                        cells=4)
    g = jax_gamma_matrix(prob)
    for a, b in ((BucketedLayout.from_problem(port_prob),
                  RefLayout.from_problem(prob)),
                 (BucketedLayout.from_problem(port_prob, gamma=g),
                  RefLayout.from_problem(prob, gamma=g))):
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.mask, b.mask)


def test_from_support_rejects_non_matrix():
    with pytest.raises(ValueError, match="support"):
        BucketedLayout.from_support(np.ones(4, dtype=bool))


@pytest.mark.parametrize("layout", ["auto", "dense", "bucketed"])
@pytest.mark.parametrize("shape,density", [((100, 16), 0.0625),
                                           ((100, 16), 1.0),
                                           ((100, 16), 0.25),
                                           ((100, 16), 0.26),
                                           ((10, 4), 0.25),
                                           ((64, 8), 0.125),
                                           ((63, 8), 0.125),
                                           ((64, 7), 0.125)])
def test_resolve_layout_equals_reference(layout, shape, density):
    n, k = shape
    supp = np.zeros(shape, dtype=bool)
    supp.reshape(-1)[:int(round(density * n * k))] = True
    assert resolve_layout(layout, support=supp) \
        == ref_resolve(layout, support=supp)


def test_resolve_layout_from_problem_and_unknown_name():
    prob, _ = sparse_cell_instance(num_users=300, num_servers=32, cells=4)
    ref_prob, _ = jax_instances.sparse_cell_instance(num_users=300,
                                                     num_servers=32, cells=4)
    assert resolve_layout("auto", problem=prob) \
        == ref_resolve("auto", problem=ref_prob) == "bucketed"
    with pytest.raises(ValueError, match="layout"):
        resolve_layout("csr", support=np.ones((4, 2)))


def test_constants_equal_reference():
    from repro.core import layout as ref_layout
    for name in ("LAYOUTS", "AUTO_DENSITY_MAX", "AUTO_MIN_USERS",
                 "AUTO_MIN_SERVERS"):
        assert getattr(port_layout, name) == getattr(ref_layout, name), name
