"""HDR -> LDR tonemapping ops.

Replaces the reference's compute-shader tonemapper
(`src/pbr_engine/engine/pbr/TonemapperSystem.cpp:97-134` dispatching
`assets/shaders/tonemappers/aces+gamma.glsl`).  The ACES fitted matrices and
the RRT+ODT rational are reproduced with the reference's exact constants
(`aces+gamma.glsl:10-28`), followed by gamma 2.2 (`Gamma.lib.glsl:4-6`) and
clamp to [0,1] (`aces+gamma.glsl:38`), so tonemapped output is bit-comparable
up to float math.

Differentiable (used by inverse rendering when the loss is in display
space) and used by the CLI renderer; XLA fuses the whole chain.  The 3x3
colour matrices are applied at HIGHEST precision: a float32 contraction may
otherwise run in TF32 on a GPU, which keeps about three decimal digits.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_HIGHEST = jax.lax.Precision.HIGHEST

# Stephen Hill ACES fit, constants verbatim from the reference shader
# (aces+gamma.glsl:10-19).  GLSL mat3 constructors are COLUMN-major and the
# shader computes `M * color` without transposing, so the effective transform
# is the transpose of the literal rows: out = color @ M_rows.  We reproduce
# that exactly (including the reference's transpose quirk vs the canonical
# Hill HLSL fit) so converged renders are comparable.
ACES_INPUT = jnp.array(
    [[0.59719, 0.35458, 0.04823],
     [0.07600, 0.90834, 0.01566],
     [0.02840, 0.13383, 0.83777]], dtype=jnp.float32)
ACES_OUTPUT = jnp.array(
    [[1.60475, -0.53108, -0.07367],
     [-0.10208, 1.10813, -0.00605],
     [-0.00327, -0.07276, 1.07602]], dtype=jnp.float32)


def rrt_and_odt_fit(c: jnp.ndarray) -> jnp.ndarray:
    """Rational RRT+ODT fit (aces+gamma.glsl:21-25)."""
    num = c * (c + 0.0245786) - 0.000090537
    den = c * (0.983729 * c + 0.4329510) + 0.238081
    return num / den


def aces_tonemap(hdr: jnp.ndarray) -> jnp.ndarray:
    """ACES fitted tonemap of linear HDR RGB [..., 3] (aces+gamma.glsl:27-29)."""
    c = jnp.matmul(hdr, ACES_INPUT, precision=_HIGHEST)
    c = rrt_and_odt_fit(c)
    return jnp.matmul(c, ACES_OUTPUT, precision=_HIGHEST)


def gamma_correct(c: jnp.ndarray, gamma: float = 2.2) -> jnp.ndarray:
    """pow(c, 1/gamma) on non-negative input (Gamma.lib.glsl:4-6)."""
    return jnp.power(jnp.maximum(c, 0.0), 1.0 / gamma)


def aces_gamma(hdr: jnp.ndarray, gamma: float = 2.2) -> jnp.ndarray:
    """Full reference post chain: ACES fit -> gamma 2.2 -> clamp [0,1]
    (aces+gamma.glsl:31-40)."""
    ldr = aces_tonemap(hdr)
    ldr = gamma_correct(ldr, gamma)
    return jnp.clip(ldr, 0.0, 1.0)


def linear_to_srgb(c: jnp.ndarray) -> jnp.ndarray:
    """Exact sRGB OETF (the reference swapchain is *Unorm + SrgbNonlinear
    colorspace; gamma 2.2 approximates this — provided for completeness)."""
    c = jnp.clip(c, 0.0, 1.0)
    lo = c * 12.92
    hi = 1.055 * jnp.power(jnp.maximum(c, 1e-7), 1.0 / 2.4) - 0.055
    return jnp.where(c <= 0.0031308, lo, hi)


def srgb_to_linear(c: jnp.ndarray) -> jnp.ndarray:
    """Inverse sRGB OETF (used when decoding 8-bit albedo textures)."""
    c = jnp.clip(c, 0.0, 1.0)
    lo = c / 12.92
    hi = jnp.power((c + 0.055) / 1.055, 2.4)
    return jnp.where(c <= 0.04045, lo, hi)
