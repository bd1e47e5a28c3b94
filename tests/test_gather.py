"""Zero-fill row gather: exactness, out-of-range rows, 1-D form and VJP."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from physically_based_renderer_tpu.ops.gather import take_rows, take_values


@pytest.mark.parametrize("t,w", [(36, 8), (64, 52), (513, 16)])
def test_forward_exact(t, w):
    key = jax.random.key(0)
    table = jax.random.normal(key, (t, w), jnp.float32) * 1e3
    idx = jax.random.randint(jax.random.key(1), (1000,), 0, t)
    out = jax.jit(take_rows)(table, idx)
    ref = np.asarray(table)[np.asarray(idx)]
    np.testing.assert_array_equal(np.asarray(out), ref)


def test_out_of_range_zeros():
    table = jnp.arange(12.0).reshape(4, 3)
    idx = jnp.array([-1, 0, 3, 4, 100, -7], jnp.int32)
    out = np.asarray(take_rows(table, idx))
    ref = np.asarray(table)[np.clip(np.asarray(idx), 0, 3)]
    ref[(np.asarray(idx) < 0) | (np.asarray(idx) > 3)] = 0.0
    np.testing.assert_array_equal(out, ref)
    assert (out[0] == 0).all() and (out[3] == 0).all()
    np.testing.assert_array_equal(
        np.asarray(take_values(table[:, 0], idx)), ref[:, 0])


def test_vjp_matches_segment_sum():
    """d table = segment-sum of the cotangents of in-range rows."""
    t, w, n = 40, 8, 300
    table = jax.random.normal(jax.random.key(0), (t, w), jnp.float32)
    idx = jax.random.randint(jax.random.key(1), (n,), -2, t)
    wgt = jax.random.normal(jax.random.key(2), (n, w), jnp.float32)

    g = jax.grad(lambda tab: jnp.sum(take_rows(tab, idx) * wgt))(table)
    ref = np.zeros((t, w), np.float32)
    for i, r in enumerate(np.asarray(idx)):
        if 0 <= r < t:
            ref[r] += np.asarray(wgt)[i]
    np.testing.assert_allclose(np.asarray(g), ref, rtol=1e-6, atol=1e-6)
