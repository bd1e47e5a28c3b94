"""Light models + next-event-estimation sampling.

Light family (SURVEY.md section 2.10 / BASELINE north star):
  * area emitters  — emissive glTF materials on triangles (the reference has
    no lights at all beyond its headlight hack, `pbr/lighting.glsl:25-27`);
  * directional    — sun / headlight;
  * environment    — equirect HDR map with 2D-CDF importance sampling.

All samplers return solid-angle pdfs so the integrator can MIS them against
BSDF sampling (balance/power heuristic).  Sampling decisions consume plain
U[0,1) numbers so the caller controls the RNG (core/rng.py keying).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..ops.gather import take_rows
from ..ops.texture import sample_env_bilinear
from ..scene.types import Scene

BIG = 1e30


@struct.dataclass
class LightSample:
    """One NEE sample per ray."""

    wi: jnp.ndarray        # f32[N,3] unit direction toward the light
    dist: jnp.ndarray      # f32[N] distance to the light (BIG for infinite)
    radiance: jnp.ndarray  # f32[N,3] emitted radiance toward the shading pt
    pdf: jnp.ndarray       # f32[N] solid-angle pdf (0 => invalid sample)
    valid: jnp.ndarray     # bool[N]


def dense_tri_pdf_area(scene: Scene) -> jnp.ndarray:
    """Per-triangle area-measure pdf of NEE picking that triangle point:
    p_A(tri) = P(tri) / area(tri); 0 for non-emitters.  Used for MIS when a
    BSDF ray happens to hit an emitter."""
    t = scene.geometry.num_tris
    dense = jnp.zeros((t,), jnp.float32)
    p = jnp.where(scene.emitters.valid,
                  scene.emitters.pdf_tri / jnp.maximum(scene.emitters.area,
                                                       1e-12), 0.0)
    return dense.at[scene.emitters.tri_idx].add(p)


def pack_emitter_attrs(scene: Scene) -> jnp.ndarray:
    """Per-emitter sampling table f32[E, 20]: v0 | e1 | e2 | pdf/area |
    emissive radiance (ATTACHED to materials.emissive_factor) | uv0 |
    duv1 | duv2 | emissive-texture slot id (-1 = untextured).

    Built once per frame so each NEE bounce needs a single row fetch
    instead of ~12 separate gathers.  The uv columns let NEE evaluate the
    emissive TEXTURE at the sampled light point (sample_area_emitters) so
    its radiance matches what a BSDF ray hitting the same point sees
    (integrator/shading.py emissive = factor x texture) — required for
    unbiased MIS on textured emitters.
    """
    em = scene.emitters
    g = scene.geometry
    idx = g.indices[em.tri_idx]                      # [E, 3]
    v0 = g.positions[idx[:, 0]]
    v1 = g.positions[idx[:, 1]]
    v2 = g.positions[idx[:, 2]]
    pdf_a = jnp.where(em.valid,
                      em.pdf_tri / jnp.maximum(em.area, 1e-12), 0.0)
    mat = g.tri_material[em.tri_idx]
    radiance = scene.materials.emissive_factor[mat]
    uv0 = g.uvs[idx[:, 0]]
    duv1 = g.uvs[idx[:, 1]] - uv0
    duv2 = g.uvs[idx[:, 2]] - uv0
    em_tex = scene.materials.emissive_tex[mat].astype(jnp.float32)
    return jnp.concatenate([
        v0, v1 - v0, v2 - v0, pdf_a[:, None], radiance,
        uv0, duv1, duv2, em_tex[:, None],
    ], axis=1)


def sample_area_emitters(scene: Scene, p: jnp.ndarray, u1: jnp.ndarray,
                         u2: jnp.ndarray,
                         emitter_attrs: jnp.ndarray | None = None,
                         pyramid=None) -> LightSample:
    """Sample a point on the emissive triangles from shading points p[N,3].

    u1[N] picks the emitter (CDF inversion), u2[N,2] the point (uniform
    barycentric).  Emission is one-sided: a point emits only into the
    hemisphere of its geometric normal.  When the scene has emissive
    textures (tex_slots[3]) the sampled radiance includes the texture at
    the light point (level-0 bilinear — NEE has no ray cone), matching the
    emitter-hit path's factor x texture; `pyramid` (ops.texture pyramid)
    can be passed to amortize the build.
    """
    em = scene.emitters
    n = p.shape[0]
    if emitter_attrs is None:
        emitter_attrs = pack_emitter_attrs(scene)
    # Emitter pick: dense CDF compare for small counts (pure elementwise
    # work); for emitter-rich scenes (e.g. a ~7.8k-tri emissive visor) the
    # Walker alias table gives the SAME distribution in O(1) — 2 gathers,
    # vs a [N, E] compare (4G lanes at 262k x 15k) or ~13 dependent
    # searchsorted gather rounds.
    # u1 splits into (slot, accept) via the standard fractional reuse:
    # slot = floor(u1*E), accept on frac(u1*E) — both uniform.
    if em.num_emitters <= 64:
        e_idx = jnp.sum((em.cdf[None, :] < u1[:, None]).astype(jnp.int32),
                        axis=-1)
    else:
        m = em.num_emitters
        scaled = u1 * m
        slot = jnp.clip(scaled.astype(jnp.int32), 0, m - 1)
        frac = scaled - slot.astype(jnp.float32)
        accept = frac < em.alias_prob[slot]
        e_idx = jnp.where(accept, slot, em.alias_idx[slot])
    e_idx = jnp.clip(e_idx, 0, em.num_emitters - 1)
    rows = take_rows(emitter_attrs, e_idx)           # [N, 20] ONE fetch
    v0 = rows[:, 0:3]
    e1 = rows[:, 3:6]
    e2 = rows[:, 6:9]
    pdf_a = rows[:, 9]                               # pdf_tri / area
    radiance = rows[:, 10:13]

    # Uniform triangle sampling (sqrt trick)
    su = jnp.sqrt(jnp.clip(u2[:, 0], 0.0, 1.0))
    b1 = 1.0 - su
    b2 = u2[:, 1] * su
    lp = v0 + b1[:, None] * e1 + b2[:, None] * e2

    if scene.tex_slots[3]:
        from ..ops.texture import build_pyramid, sample_slot, texture_meta
        if pyramid is None:
            pyramid = build_pyramid(scene.textures)
        uv_l = (rows[:, 13:15] + b1[:, None] * rows[:, 15:17]
                + b2[:, None] * rows[:, 17:19])
        meta_tab = jnp.asarray(texture_meta(scene.textures))
        tex_id = rows[:, 19].astype(jnp.int32)
        meta = jnp.where((tex_id >= 0)[:, None],
                         meta_tab[jnp.maximum(tex_id, 0)], -1.0)
        tex = sample_slot(pyramid, meta, uv_l, None)
        radiance = radiance * tex[:, :3]
    ng = jnp.cross(e1, e2)
    ng2 = jnp.maximum(jnp.sum(ng * ng, axis=-1, keepdims=True), 1e-20)
    ng = ng * jax.lax.rsqrt(ng2)

    to_l = lp - p
    dist2 = jnp.maximum(jnp.sum(to_l * to_l, axis=-1), 1e-12)
    dist = jnp.sqrt(dist2)
    wi = to_l / dist[:, None]
    cos_l = jnp.sum(ng * (-wi), axis=-1)        # light-side cosine

    pdf_sa = pdf_a * dist2 / jnp.maximum(cos_l, 1e-6)
    valid = (cos_l > 1e-6) & (pdf_a > 0.0)
    zero = jnp.zeros((n,), jnp.float32)
    return LightSample(
        wi=wi, dist=dist,
        radiance=jnp.where(valid[:, None], radiance, 0.0),
        pdf=jnp.where(valid, pdf_sa, zero),
        valid=valid)


def sample_directional(scene: Scene, n_rays: int) -> LightSample:
    """Delta directional light: wi = -light.direction, pdf treated as 1
    (delta measure; never MIS-weighted against BSDF sampling)."""
    d = scene.directional
    wi = jnp.broadcast_to(-d.direction, (n_rays, 3))
    radiance = jnp.broadcast_to(d.radiance, (n_rays, 3))
    on = jnp.sum(d.radiance) > 0.0
    valid = jnp.broadcast_to(on, (n_rays,))
    return LightSample(wi=wi, dist=jnp.full((n_rays,), BIG, jnp.float32),
                       radiance=radiance,
                       pdf=jnp.ones((n_rays,), jnp.float32),
                       valid=valid)


def sample_env(scene: Scene, n_rays: int, u2: jnp.ndarray) -> LightSample:
    """Importance-sample the environment map via the Walker alias table.

    Exactly the texel distribution the 2D-CDF tables encode, but O(1):
    u2[:,0] picks the slot, u2[:,1] the accept/alias branch — 2 gathers
    instead of log2(W)+log2(H) dependent binary-search rounds.
    """
    env = scene.env
    h, w = env.data.shape[0], env.data.shape[1]
    m = h * w
    slot = jnp.clip((u2[:, 0] * m).astype(jnp.int32), 0, m - 1)
    accept = u2[:, 1] < env.alias_prob[slot]
    texel_s = jnp.where(accept, slot, env.alias_idx[slot])
    row = texel_s // w
    col = texel_s - row * w
    theta = (row.astype(jnp.float32) + 0.5) / h * jnp.pi
    phi = ((col.astype(jnp.float32) + 0.5) / w - 0.5) * 2.0 * jnp.pi
    sin_t = jnp.sin(theta)
    wi = jnp.stack([sin_t * jnp.cos(phi), jnp.cos(theta),
                    sin_t * jnp.sin(phi)], axis=-1)
    texel = row * w + col
    radiance = env.data.reshape(-1, 3)[texel]
    pdf = env.pdf.reshape(-1)[texel]
    valid = pdf > 0.0
    return LightSample(wi=wi, dist=jnp.full((n_rays,), BIG, jnp.float32),
                       radiance=radiance, pdf=pdf, valid=valid)


def env_pdf(scene: Scene, d: jnp.ndarray) -> jnp.ndarray:
    """Solid-angle pdf of env NEE producing direction d[N,3] (for MIS)."""
    env = scene.env
    h, w = env.data.shape[0], env.data.shape[1]
    theta = jnp.arccos(jnp.clip(d[:, 1], -1.0, 1.0))
    phi = jnp.arctan2(d[:, 2], d[:, 0])
    row = jnp.clip((theta / jnp.pi * h).astype(jnp.int32), 0, h - 1)
    col = jnp.clip(((phi / (2.0 * jnp.pi) + 0.5) * w).astype(jnp.int32),
                   0, w - 1)
    return env.pdf.reshape(-1)[row * w + col]


def env_radiance(scene: Scene, d: jnp.ndarray) -> jnp.ndarray:
    """Environment radiance for escaped rays (bilinear)."""
    return sample_env_bilinear(scene.env.data, d)
