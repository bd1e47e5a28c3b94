"""BSDF model family: glTF 2.0 metallic-roughness (GGX + Lambert + Schlick).

This is the physically based upgrade of the reference's shading: the
reference names its pass "PBR" but actually evaluates headlight Blinn-Phong
(`assets/shaders/BlinnPhong.lib.glsl:4-10`) over a baseColor-only material
(`src/pbr_engine/engine/pbr/Material.hpp:14-16`).  Per the north star
(BASELINE.json) we implement the full glTF metallic-roughness BRDF:

    c_diff = base_color * (1 - metallic)
    F0     = lerp(0.04, base_color, metallic)
    f      = (1 - F(VoH)) * c_diff/pi  +  D_GGX * Vis_Smith * F(VoH)

with Trowbridge-Reitz (GGX) D, height-correlated Smith visibility, and
Fresnel-Schlick.  Sampling mixes cosine-hemisphere (diffuse) with Heitz VNDF
(specular); every function returns (value, pdf) so NEE/MIS can weight.

All directions are in the LOCAL SHADING FRAME (+z = shading normal), unit
length, with wo pointing away from the surface toward the viewer.  Everything
broadcasts over leading batch dims and is differentiable in the material
parameters (sampled directions/pdfs are detached by callers per the
interior-term gradient strategy, see grad/).

A Blinn-Phong debug mode reproducing the reference's lighting exactly is in
`models.blinn_phong` (kept cheap per SURVEY.md "non-goals... kept only as a
debug shading mode if cheap").
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import struct

INV_PI = 0.31830988618379067
MIN_ALPHA = 1e-4
MIN_ROUGHNESS = 1e-2


def _safe_normalize(v: jnp.ndarray) -> jnp.ndarray:
    """Normalize with a NaN-SAFE GRADIENT at ||v||=0 (jnp.linalg.norm's
    gradient at zero is NaN, which poisons masked lanes through jnp.where —
    the standard where-trap)."""
    n2 = jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=True), 1e-20)
    return v * jax.lax.rsqrt(n2)


@struct.dataclass
class BsdfParams:
    """Per-hit material parameters (after texture lookups)."""

    base_color: jnp.ndarray  # f32[..., 3] linear
    metallic: jnp.ndarray    # f32[...]
    roughness: jnp.ndarray   # f32[...]
    # KHR_materials_specular scale on dielectric F0; 1.0 = core glTF.
    specular: jnp.ndarray    # f32[...]

    @property
    def alpha(self) -> jnp.ndarray:
        r = jnp.clip(self.roughness, MIN_ROUGHNESS, 1.0)
        return jnp.maximum(r * r, MIN_ALPHA)

    @property
    def f0(self) -> jnp.ndarray:
        m = self.metallic[..., None]
        return 0.04 * self.specular[..., None] * (1.0 - m) + self.base_color * m

    @property
    def diffuse_color(self) -> jnp.ndarray:
        return self.base_color * (1.0 - self.metallic[..., None])


def cos_theta(w: jnp.ndarray) -> jnp.ndarray:
    return w[..., 2]


# ---------------------------------------------------------------------------
# Microfacet pieces
# ---------------------------------------------------------------------------

def d_ggx(alpha: jnp.ndarray, h: jnp.ndarray) -> jnp.ndarray:
    """Trowbridge-Reitz NDF, local frame."""
    a2 = alpha * alpha
    nh = jnp.maximum(cos_theta(h), 0.0)
    d = nh * nh * (a2 - 1.0) + 1.0
    return a2 * INV_PI / jnp.maximum(d * d, 1e-12)


def smith_lambda(alpha: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """Smith's lambda for GGX: (sqrt(1 + a^2 tan^2) - 1)/2."""
    c = jnp.clip(jnp.abs(cos_theta(w)), 1e-6, 1.0)
    tan2 = jnp.maximum(1.0 - c * c, 0.0) / (c * c)
    return 0.5 * (jnp.sqrt(1.0 + alpha * alpha * tan2) - 1.0)


def vis_smith_hc(alpha: jnp.ndarray, wo: jnp.ndarray,
                 wi: jnp.ndarray) -> jnp.ndarray:
    """Height-correlated Smith visibility V = G2 / (4 |NL| |NV|)."""
    no = jnp.maximum(jnp.abs(cos_theta(wo)), 1e-6)
    ni = jnp.maximum(jnp.abs(cos_theta(wi)), 1e-6)
    lam = smith_lambda(alpha, wo) + smith_lambda(alpha, wi)
    return 1.0 / (4.0 * no * ni * (1.0 + lam))


def g1_smith(alpha: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    return 1.0 / (1.0 + smith_lambda(alpha, w))


def fresnel_schlick(f0: jnp.ndarray, voh: jnp.ndarray) -> jnp.ndarray:
    m = jnp.clip(1.0 - voh, 0.0, 1.0)
    return f0 + (1.0 - f0) * (m ** 5)[..., None]


# ---------------------------------------------------------------------------
# Eval
# ---------------------------------------------------------------------------

def eval_bsdf(params: BsdfParams, wo: jnp.ndarray, wi: jnp.ndarray):
    """BRDF value f(wo, wi) [...,3] and its sampling pdf [...].

    Zero when wi is below the hemisphere (opaque surface).
    """
    no = cos_theta(wo)
    ni = cos_theta(wi)
    valid = (no > 1e-6) & (ni > 1e-6)

    h = _safe_normalize(wo + wi)
    voh = jnp.maximum(jnp.sum(wo * h, axis=-1), 0.0)

    alpha = params.alpha
    f = fresnel_schlick(params.f0, voh)
    spec = (d_ggx(alpha, h) * vis_smith_hc(alpha, wo, wi))[..., None] * f
    diff = params.diffuse_color * INV_PI * (1.0 - f)
    val = jnp.where(valid[..., None], diff + spec, 0.0)

    pdf = _pdf(params, wo, wi, h)
    pdf = jnp.where(valid, pdf, 0.0)
    return val, pdf


def _spec_select_prob(params: BsdfParams) -> jnp.ndarray:
    """Probability of sampling the specular lobe: energy-based heuristic."""
    lum = jnp.array([0.2126, 0.7152, 0.0722], jnp.float32)
    ls = jnp.maximum(jnp.sum(params.f0 * lum, axis=-1), 1e-4)
    ld = jnp.maximum(jnp.sum(params.diffuse_color * lum, axis=-1), 0.0)
    return jnp.clip(ls / (ls + ld), 0.05, 0.99)


def _pdf_vndf(alpha, wo, h) -> jnp.ndarray:
    """PDF of wi when h is drawn from the visible-normal distribution:
    p(wi) = G1(wo) D(h) max(0,VoH) / |NV| / (4 VoH) = G1 D / (4 |NV|)."""
    no = jnp.maximum(jnp.abs(cos_theta(wo)), 1e-6)
    return g1_smith(alpha, wo) * d_ggx(alpha, h) / (4.0 * no)


def _pdf(params: BsdfParams, wo, wi, h) -> jnp.ndarray:
    ps = _spec_select_prob(params)
    pdf_d = jnp.maximum(cos_theta(wi), 0.0) * INV_PI
    pdf_s = _pdf_vndf(params.alpha, wo, h)
    return ps * pdf_s + (1.0 - ps) * pdf_d


def pdf_bsdf(params: BsdfParams, wo: jnp.ndarray, wi: jnp.ndarray):
    h = _safe_normalize(wo + wi)
    pdf = _pdf(params, wo, wi, h)
    return jnp.where((cos_theta(wo) > 1e-6) & (cos_theta(wi) > 1e-6), pdf, 0.0)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def sample_cosine_hemisphere(u2: jnp.ndarray) -> jnp.ndarray:
    """Cosine-weighted hemisphere direction from u in [0,1)^2 (local frame)."""
    r = jnp.sqrt(u2[..., 0])
    phi = 2.0 * jnp.pi * u2[..., 1]
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(1.0 - u2[..., 0], 0.0))
    return jnp.stack([x, y, z], axis=-1)


def sample_vndf_ggx(alpha: jnp.ndarray, wo: jnp.ndarray,
                    u2: jnp.ndarray) -> jnp.ndarray:
    """Heitz 2018 visible-normal GGX sampling -> half vector h (local)."""
    a = alpha[..., None]
    vh = jnp.stack([a[..., 0] * wo[..., 0], a[..., 0] * wo[..., 1],
                    wo[..., 2]], axis=-1)
    vh = _safe_normalize(vh)
    # Orthonormal basis around vh
    lensq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv = 1.0 / jnp.sqrt(jnp.maximum(lensq, 1e-12))
    t1 = jnp.where(lensq[..., None] > 1e-9,
                   jnp.stack([-vh[..., 1] * inv, vh[..., 0] * inv,
                              jnp.zeros_like(inv)], axis=-1),
                   jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0], jnp.float32),
                                    vh.shape))
    t2 = jnp.cross(vh, t1)
    r = jnp.sqrt(u2[..., 0])
    phi = 2.0 * jnp.pi * u2[..., 1]
    p1 = r * jnp.cos(phi)
    p2 = r * jnp.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    p2 = (1.0 - s) * jnp.sqrt(jnp.maximum(1.0 - p1 * p1, 0.0)) + s * p2
    p3 = jnp.sqrt(jnp.maximum(1.0 - p1 * p1 - p2 * p2, 0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + p3[..., None] * vh
    h = jnp.stack([a[..., 0] * nh[..., 0], a[..., 0] * nh[..., 1],
                   jnp.maximum(nh[..., 2], 1e-6)], axis=-1)
    return _safe_normalize(h)


def sample_bsdf(params: BsdfParams, wo: jnp.ndarray, u_lobe: jnp.ndarray,
                u2: jnp.ndarray):
    """Draw wi ~ p(.|wo); returns (wi, f, pdf).

    u_lobe [...] selects the lobe; u2 [..., 2] drives the chosen sampler.
    All returned quantities are computed for the MIXTURE pdf so the estimator
    f/pdf is unbiased regardless of which lobe fired.
    """
    ps = _spec_select_prob(params)
    # diffuse candidate
    wi_d = sample_cosine_hemisphere(u2)
    # specular candidate via VNDF
    h = sample_vndf_ggx(params.alpha, wo, u2)
    wi_s = 2.0 * jnp.sum(wo * h, axis=-1, keepdims=True) * h - wo
    use_spec = u_lobe < ps
    wi = _safe_normalize(jnp.where(use_spec[..., None], wi_s, wi_d))
    f, pdf = eval_bsdf(params, wo, wi)
    return wi, f, pdf
