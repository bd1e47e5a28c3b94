"""Tonemap tests: pin the reference's exact ACES+gamma chain
(assets/shaders/tonemappers/aces+gamma.glsl)."""

import jax
import numpy as np
import jax.numpy as jnp

from physically_based_renderer_tpu.core import tonemap


def _glsl_aces(rgb):
    """Scalar recreation of the GLSL shader math (column-major mat3 M*v)."""
    lit_in = np.array([[0.59719, 0.35458, 0.04823],
                       [0.07600, 0.90834, 0.01566],
                       [0.02840, 0.13383, 0.83777]])
    lit_out = np.array([[1.60475, -0.53108, -0.07367],
                        [-0.10208, 1.10813, -0.00605],
                        [-0.00327, -0.07276, 1.07602]])
    # GLSL: literal rows are columns; M*v uses effective matrix = lit.T
    c = lit_in.T @ rgb
    num = c * (c + 0.0245786) - 0.000090537
    den = c * (0.983729 * c + 0.4329510) + 0.238081
    c = num / den
    c = lit_out.T @ c
    return np.clip(np.power(np.clip(c, 0, None), 1 / 2.2), 0.0, 1.0)


def test_matches_glsl_reference_math():
    rng = np.random.default_rng(0)
    hdr = rng.uniform(0.0, 8.0, (32, 3)).astype(np.float32)
    ours = np.asarray(tonemap.aces_gamma(jnp.asarray(hdr)))
    ref = np.stack([_glsl_aces(c) for c in hdr])
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_output_in_unit_range():
    hdr = jnp.array([[0.0, 0.0, 0.0], [100.0, 50.0, 25.0], [1e4, 1e4, 1e4]])
    out = np.asarray(tonemap.aces_gamma(hdr))
    assert (out >= 0.0).all() and (out <= 1.0).all()


def test_monotonic_in_exposure():
    grays = jnp.linspace(0.01, 20.0, 64)[:, None] * jnp.ones((1, 3))
    out = np.asarray(tonemap.aces_gamma(grays))[:, 0]
    assert (np.diff(out) >= -1e-6).all()


def test_srgb_roundtrip():
    x = jnp.linspace(0.0, 1.0, 128)
    back = np.asarray(tonemap.srgb_to_linear(tonemap.linear_to_srgb(x)))
    np.testing.assert_allclose(back, np.asarray(x), atol=1e-5)


def test_differentiable():
    import jax
    g = jax.grad(lambda h: tonemap.aces_gamma(h).sum())(
        jnp.array([1.0, 2.0, 3.0]))
    assert np.isfinite(np.asarray(g)).all()


def _aces_gamma_f64(hdr):
    """float64 numpy recreation of core.tonemap.aces_gamma."""
    m_in = np.asarray(tonemap.ACES_INPUT, np.float64)
    m_out = np.asarray(tonemap.ACES_OUTPUT, np.float64)
    c = np.asarray(hdr, np.float64) @ m_in
    c = (c * (c + 0.0245786) - 0.000090537) / (
        c * (0.983729 * c + 0.4329510) + 0.238081)
    c = c @ m_out
    return np.clip(np.power(np.maximum(c, 0.0), 1 / 2.2), 0.0, 1.0)


def test_matches_float64_numpy():
    """aces_gamma == the float64 reference on an image-shaped input (the
    colour matrices run at HIGHEST precision, never TF32)."""
    rng = np.random.default_rng(3)
    hdr = rng.uniform(0.0, 12.0, (33, 47, 3)).astype(np.float32)
    got = np.asarray(jax.jit(tonemap.aces_gamma)(jnp.asarray(hdr)))
    np.testing.assert_allclose(got, _aces_gamma_f64(hdr), atol=1e-6)
    assert got.shape == hdr.shape


def test_zero_and_huge_inputs():
    hdr = jnp.array([[[0.0, 0.0, 0.0], [1e6, 0.5, 0.0]]], jnp.float32)
    out = np.asarray(tonemap.aces_gamma(hdr))
    np.testing.assert_allclose(out, _aces_gamma_f64(np.asarray(hdr)),
                               atol=1e-6)
    assert np.isfinite(out).all()
