"""Surface shading-point construction from hit records.

The analog of the reference's G-buffer fill (geometry-pass fragment
shader `assets/shaders/geometry_pass/fragment.glsl:19-31`): interpolate
vertex attributes at the hit, run normal mapping through the TBN frame
(bitangent = cross(N, T.xyz) * T.w, `geometry_pass/vertex.glsl:25-37`), and
fetch material parameters through the texture stack.  Instead of writing
position/normal/albedo render targets, the results feed the BSDF directly.

Performance shape (the reason for the packed layout): naive per-attribute
indexing costs ~17 independent row gathers per bounce.  Instead all
per-triangle shading data (corner positions as v0/e1/e2, normals, tangents,
uvs) is packed ONCE per frame into a single wide table f32[T, 53]
(pack_tri_attrs — attached, so vertex gradients still flow) and each bounce
does ONE wide-row gather.  The attached winner re-intersection (barycentrics
u, v from Moller-Trumbore on the gathered v0/e1/e2) also lives here, so
tracers are free to return fully detached hits (ops/blocktrace.py does the
search detached).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import struct

from ..core import math3d
from ..models.bsdf import BsdfParams
from ..ops.gather import take_rows
from ..ops.intersect import Hit
from ..ops.texture import (META_W, TexturePyramid, build_pyramid,
                           sample_slot, texture_meta)
from ..scene.types import MIP_LINEAR, Scene

sg = jax.lax.stop_gradient

# Column offsets of the packed per-triangle attribute row (pack_tri_attrs).
COL_FACTORS = 36       # 36:40 base_color | 40 metallic | 41 roughness |
#                        42:45 emissive | 45 specular | 46 normal_scale
COL_MAT = 47
COL_PDF_AREA = 48
COL_UV_DENSITY = 49
COL_META = 50          # 4 slots x META_W texture metadata
ATTR_W = COL_META + 4 * META_W


@struct.dataclass
class ShadingPoint:
    pos: jnp.ndarray       # f32[N,3] world hit position
    ng: jnp.ndarray        # f32[N,3] geometric normal (faces the incoming ray)
    ns: jnp.ndarray        # f32[N,3] shading normal (normal-mapped, oriented)
    tang: jnp.ndarray      # f32[N,3] tangent of the shading frame
    bitang: jnp.ndarray    # f32[N,3]
    uv: jnp.ndarray        # f32[N,2]
    bsdf: BsdfParams       # per-hit material parameters
    emissive: jnp.ndarray  # f32[N,3] emitted radiance (front side)
    front: jnp.ndarray     # bool[N] ray hit the geometric front face
    mat: jnp.ndarray       # i32[N] material id
    pdf_area: jnp.ndarray  # f32[N] NEE area-pdf of this triangle (MIS)


def pack_tri_attrs(scene: Scene) -> jnp.ndarray:
    """Pack per-triangle shading attributes into one wide table f32[T, 86].

    Columns: 0:3 v0 | 3:6 e1 | 6:9 e2 (ATTACHED to geometry.positions) |
    9:18 corner normals | 18:30 corner tangent4s | 30:36 corner uvs |
    36:40 base_color_factor | 40 metallic | 41 roughness | 42:45 emissive |
    45 specular | 46 normal_scale (ATTACHED to materials) | 47 material id |
    48 NEE area-measure pdf of the triangle (models/lights.py, for MIS) |
    49 uv density sqrt(uv_area / world_area) (ray-cone mip selection) |
    50.. four ops.texture.texture_meta rows (base_color, metallic_roughness,
    normal, emissive slots; off0 = -1 marks "no texture").
    Built once per frame; every bounce then needs a single [N, 86] row
    fetch (ops/gather.take_rows) instead of ~17 separate gathers — and the
    embedded texture metadata makes each texture fetch metadata-free.
    """
    from ..models.lights import dense_tri_pdf_area
    g = scene.geometry
    m = scene.materials
    i0, i1, i2 = g.indices[:, 0], g.indices[:, 1], g.indices[:, 2]
    v0 = g.positions[i0]
    e1 = g.positions[i1] - v0
    e2 = g.positions[i2] - v0
    tm = g.tri_material
    f32 = lambda x: x.astype(jnp.float32)

    uv0, uv1, uv2 = g.uvs[i0], g.uvs[i1], g.uvs[i2]
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    uv_area = 0.5 * jnp.abs(duv1[:, 0] * duv2[:, 1]
                            - duv1[:, 1] * duv2[:, 0])
    w_area = 0.5 * jnp.linalg.norm(jnp.cross(e1, e2), axis=-1)
    uv_density = sg(jnp.sqrt(uv_area / jnp.maximum(w_area, 1e-20)))

    meta_tab = jnp.asarray(texture_meta(scene.textures))   # [T_tex, 9]

    def slot_meta(ids):
        rows = meta_tab[jnp.maximum(ids, 0)]               # [M, 9]
        return jnp.where((ids >= 0)[:, None], rows, -1.0)[tm]

    return jnp.concatenate([
        v0, e1, e2,
        g.normals[i0], g.normals[i1], g.normals[i2],
        g.tangents[i0], g.tangents[i1], g.tangents[i2],
        uv0, uv1, uv2,
        m.base_color_factor[tm],
        m.metallic_factor[tm][:, None],
        m.roughness_factor[tm][:, None],
        m.emissive_factor[tm],
        m.specular_factor[tm][:, None],
        m.normal_scale[tm][:, None],
        f32(tm)[:, None],
        dense_tri_pdf_area(scene)[:, None],
        uv_density[:, None],
        slot_meta(m.base_color_tex),
        slot_meta(m.metallic_roughness_tex),
        slot_meta(m.normal_tex),
        slot_meta(m.emissive_tex),
    ], axis=1)


def shade_surface(scene: Scene, hit: Hit, ray_o: jnp.ndarray,
                  ray_d: jnp.ndarray,
                  tri_attrs: jnp.ndarray | None = None,
                  pyramid: TexturePyramid | None = None,
                  cone_width: jnp.ndarray | None = None) -> ShadingPoint:
    """Build shading points for hits (garbage-but-finite values for misses;
    callers mask by hit.miss).

    `ray_o`/`ray_d` are the (attached) ray origins/directions; barycentrics
    are re-derived here attached so tracer hits may be detached.  Pass a
    prebuilt `tri_attrs` (pack_tri_attrs) and `pyramid` (build_pyramid) to
    amortize packing over bounces.  `cone_width` f32[N] is the ray cone's
    world-space diameter at the hit (pixel_cone_angle x path distance);
    None disables mip selection (level-0 bilinear everywhere).
    """
    tri = jnp.maximum(hit.tri, 0)
    if tri_attrs is None:
        tri_attrs = pack_tri_attrs(scene)
    rows = take_rows(tri_attrs, tri)                   # [N,86] ONE row fetch

    v0 = rows[:, 0:3]
    e1 = rows[:, 3:6]
    e2 = rows[:, 6:9]

    # Attached re-intersection of the winning triangle (detached-search /
    # attached-finish): gradients flow to vertex positions and the chain of
    # previous bounce origins through u, v.
    pv = jnp.cross(ray_d, e2)
    det = jnp.sum(pv * e1, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-9, 1.0 / det, 0.0)
    tv = ray_o - v0
    u = (jnp.sum(tv * pv, axis=-1) * inv_det)[:, None]
    q = jnp.cross(tv, e1)
    v = (jnp.sum(ray_d * q, axis=-1) * inv_det)[:, None]
    w = 1.0 - u - v

    pos = v0 + u * e1 + v * e2
    ns_raw = math3d.normalize(
        w * rows[:, 9:12] + u * rows[:, 12:15] + v * rows[:, 15:18])
    t4 = w * rows[:, 18:22] + u * rows[:, 22:26] + v * rows[:, 26:30]
    uv = w * rows[:, 30:32] + u * rows[:, 32:34] + v * rows[:, 34:36]

    # Geometric normal from the winding (CCW front face).
    ng = math3d.normalize(jnp.cross(e1, e2))
    front = jnp.sum(ng * ray_d, axis=-1) < 0.0
    sign = jnp.where(front, 1.0, -1.0)[:, None]
    ng_o = ng * sign          # oriented toward the incoming ray
    ns = ns_raw * sign

    mat = rows[:, COL_MAT].astype(jnp.int32)

    if scene.has_textures:
        if pyramid is None:
            pyramid = build_pyramid(scene.textures)
        trilinear = any(f[2] == MIP_LINEAR for f in scene.textures.filt)
        if cone_width is None:
            lod = None
        else:
            # Ray-cone LOD (Akenine-Moller ray cones, simplified: no
            # curvature/BSDF spread): footprint at the hit = cone width
            # stretched by 1/|cos| grazing and converted to uv space by the
            # triangle's uv density; the per-texture size term is added in
            # sample_slot.  Entirely a (detached) sampling decision.
            cosg = jnp.abs(jnp.sum(sg(ng) * ray_d, axis=-1))
            foot = (sg(cone_width) * rows[:, COL_UV_DENSITY]
                    / jnp.maximum(cosg, 0.08))
            lod = jnp.log2(jnp.maximum(sg(foot), 1e-30))

        def meta(slot):
            c = COL_META + slot * META_W
            return rows[:, c:c + META_W]

    # TBN frame: tangent orthogonalized against the shading normal,
    # bitangent = cross(N, T) * T.w  (geometry_pass/vertex.glsl:30-32).
    t = t4[:, :3] - jnp.sum(t4[:, :3] * ns, axis=-1, keepdims=True) * ns
    t = math3d.normalize(t)
    b = jnp.cross(ns, t) * t4[:, 3:4]

    if scene.tex_slots[2]:
        # Normal mapping (geometry_pass/fragment.glsl:23-27: n = tex*2-1,
        # TBN*n), with glTF normal_scale on the tangential components.
        # Statically skipped when NO material has a normal map (tex_slots).
        nm_meta = meta(2)
        has_nm = (nm_meta[:, 0] >= 0.0)[:, None]
        nm = sample_slot(pyramid, nm_meta, uv, lod, default=0.5,
                         trilinear=trilinear)[:, :3] * 2.0 - 1.0
        scale = rows[:, 46:47]
        nm = jnp.concatenate([nm[:, :2] * scale, nm[:, 2:3]], axis=-1)
        # Sanitize BEFORE normalize: lanes without a normal map carry the
        # zero vector whose normalize-gradient is NaN (where-trap).
        nm = jnp.where(has_nm, nm, jnp.array([0.0, 0.0, 1.0], jnp.float32))
        nm = math3d.normalize(nm)
        ns_mapped = math3d.normalize(
            nm[:, 0:1] * t + nm[:, 1:2] * b + nm[:, 2:3] * ns)
        ns = jnp.where(has_nm, ns_mapped, ns)

    # Keep the shading normal in the same hemisphere as the oriented
    # geometric normal (avoids light leaks from aggressive normal maps and
    # repairs meshes whose winding disagrees with their vertex normals).
    flip = jnp.sum(ns * ng_o, axis=-1, keepdims=True) < 0.0
    ns = math3d.normalize(jnp.where(flip, ns - 2.0 * jnp.sum(
        ns * ng_o, axis=-1, keepdims=True) * ng_o, ns))

    # Rebuild tangent frame around the final shading normal.
    t = t - jnp.sum(t * ns, axis=-1, keepdims=True) * ns
    t = math3d.normalize(t)
    b = jnp.cross(ns, t) * t4[:, 3:4]

    # Material parameter fetches (albedo = factor x texture, the
    # reference's `mat.color * texture(colorSampler, uv)` at
    # geometry_pass/fragment.glsl:30, extended with metallic-roughness
    # per glTF: B=metallic, G=roughness).  Each fetch is 1-2 quad-row
    # gathers, metadata-free (ops/texture.py) — and each SLOT is skipped
    # statically when no material in the scene uses it (Scene.tex_slots).
    if scene.tex_slots[0]:
        bc = sample_slot(pyramid, meta(0), uv, lod, trilinear=trilinear)
        base_color = rows[:, 36:40] * bc
    else:
        base_color = rows[:, 36:40]
    if scene.tex_slots[1]:
        mr = sample_slot(pyramid, meta(1), uv, lod, trilinear=trilinear)
        metallic = rows[:, 40] * mr[:, 2]
        roughness = rows[:, 41] * mr[:, 1]
    else:
        metallic = rows[:, 40]
        roughness = rows[:, 41]
    if scene.tex_slots[3]:
        em_tex = sample_slot(pyramid, meta(3), uv, lod,
                             trilinear=trilinear)
        emissive = rows[:, 42:45] * em_tex[:, :3]
    else:
        emissive = rows[:, 42:45]

    # One-sided emission: only the geometric front face emits.
    emissive = jnp.where(front[:, None], emissive, 0.0)

    params = BsdfParams(base_color=base_color[:, :3], metallic=metallic,
                        roughness=roughness, specular=rows[:, 45])
    return ShadingPoint(pos=pos, ng=ng_o, ns=ns, tang=t, bitang=b, uv=uv,
                        bsdf=params, emissive=emissive, front=front, mat=mat,
                        pdf_area=rows[:, COL_PDF_AREA])
