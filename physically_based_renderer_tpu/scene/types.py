"""Scene representation: flat structure-of-arrays pytrees.

Replacement for the reference's retained scene objects:
  * Mesh/PrimitiveSpan (one interleaved VB + u16 IB per mesh,
    `src/pbr_engine/engine/pbr/Mesh.hpp:15-42`)  ->  ONE global SoA geometry
    arena with per-triangle material ids (AoS->SoA: interleaved MeshVertex
    `MeshVertex.hpp:14-19` becomes positions/normals/tangents/uvs arrays).
  * Material (UBO + color/normal textures, `Material.{hpp,cpp}`)  ->  SoA
    material table, extended to FULL glTF metallic-roughness (the reference
    plumbs only baseColorFactor, `gltf/Asset.cpp:142-146`; the north star
    requires metallic/roughness/emissive too).
  * Texture/sampler objects  ->  a padded texture stack array + per-texture
    metadata (true size, wrap mode), sampled by jnp gather.
  * Scene graph (Scene/Node/Transform, `Scene.hpp:19-83`)  ->  kept host-side
    in scene/graph.py; flattening bakes world transforms into the arena
    (fastgltf DecomposeNodeMatrices analog, `gltf/Loader.cpp:18-21`).

Everything here is a core.struct pytree of device arrays: it jits, shards
(replicated per host, SURVEY.md section 2.10), donates, and differentiates
(gradients flow into material factors, texture texels, emitter radiance, and
vertex positions — the inverse-rendering parameter set).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

# Texture wrap modes (glTF sampler wrapS/T; reference loadSampler
# `gltf/Asset.cpp:103-120` maps the same enum onto vk::SamplerAddressMode).
WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2

# Texture filters (glTF sampler magFilter/minFilter; the reference creates
# real vk::Samplers from these — `PbrRenderSystem.cpp:96-121`).  Internal
# encoding: mag/min_inner 0 = nearest, 1 = linear; min_mip 0 = no mipmaps,
# 1 = snap to nearest level, 2 = trilinear (lerp two levels).
FILTER_NEAREST = 0
FILTER_LINEAR = 1
MIP_NONE = 0
MIP_NEAREST = 1
MIP_LINEAR = 2


@struct.dataclass
class Geometry:
    """World-space triangle soup (transforms baked at build)."""

    positions: jnp.ndarray    # f32[V, 3]
    normals: jnp.ndarray      # f32[V, 3]
    tangents: jnp.ndarray     # f32[V, 4] xyz tangent, w bitangent sign
    uvs: jnp.ndarray          # f32[V, 2]
    indices: jnp.ndarray      # i32[T, 3]
    tri_material: jnp.ndarray  # i32[T]

    @property
    def num_tris(self) -> int:
        return self.indices.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    def tri_vertices(self):
        """Gather per-triangle corner positions -> (v0, v1, v2) each f32[T,3]."""
        p = self.positions
        i = self.indices
        return p[i[:, 0]], p[i[:, 1]], p[i[:, 2]]


@struct.dataclass
class Materials:
    """glTF 2.0 metallic-roughness material table (SoA over materials)."""

    base_color_factor: jnp.ndarray  # f32[M, 4]
    metallic_factor: jnp.ndarray    # f32[M]
    roughness_factor: jnp.ndarray   # f32[M]
    emissive_factor: jnp.ndarray    # f32[M, 3]
    normal_scale: jnp.ndarray       # f32[M]
    # KHR_materials_specular specularFactor: scales dielectric F0 (0.04);
    # 0 => pure Lambert (BASELINE config #1 needs exact Lambertian).
    specular_factor: jnp.ndarray    # f32[M]
    # Texture indices into the TextureStack; -1 = no texture.
    base_color_tex: jnp.ndarray     # i32[M]
    metallic_roughness_tex: jnp.ndarray  # i32[M]
    normal_tex: jnp.ndarray         # i32[M]
    emissive_tex: jnp.ndarray       # i32[M]

    @property
    def num_materials(self) -> int:
        return self.base_color_factor.shape[0]

    @classmethod
    def default(cls, n: int = 1) -> "Materials":
        # numpy on purpose: scene construction is host-side (one device_put
        # stages the whole arena, the TransferStager analog — SURVEY 3.4).
        return cls(
            base_color_factor=np.ones((n, 4), np.float32),
            metallic_factor=np.zeros((n,), np.float32),
            roughness_factor=np.ones((n,), np.float32),
            emissive_factor=np.zeros((n, 3), np.float32),
            normal_scale=np.ones((n,), np.float32),
            specular_factor=np.ones((n,), np.float32),
            base_color_tex=np.full((n,), -1, np.int32),
            metallic_roughness_tex=np.full((n,), -1, np.int32),
            normal_tex=np.full((n,), -1, np.int32),
            emissive_tex=np.full((n,), -1, np.int32),
        )


@struct.dataclass
class TextureStack:
    """All scene textures as ONE flat texel arena (linear space).

    Color textures are sRGB-decoded at ingest; normal/MR maps stay linear —
    matching what the reference's Unorm sampling + shader math produce.
    Texture index -1 anywhere means "no texture"; callers substitute 1.0.

    Layout: `texels[offset(i) : offset(i) + h_i * w_i]` is texture i,
    row-major (y down, glTF convention), RGBA.  Shapes / wrap modes /
    filters are STATIC (part of the jit treedef): each texture keeps its
    exact size — no padding of every texture to a global max — and the
    sampler (ops/texture.py) specializes per stack.  The texel arena is the
    single trainable leaf for texture recovery (grad/inverse.py); the
    render-time mip pyramid + quad packing derive from it inside jit so
    texture gradients flow through filtering.

    The reference keeps vk::Images + vk::Samplers per texture
    (`Material.cpp:25-62`, sampler creation `PbrRenderSystem.cpp:96-121`);
    here image data is the arena and the "sampler object" is the static
    (wrap, filter) metadata.
    """

    texels: jnp.ndarray  # f32[R, 4] concatenated row-major texels
    # Static per-texture metadata (tuples => hashable, part of treedef):
    shapes: tuple = struct.field(pytree_node=False)   # ((h, w), ...)
    wrap: tuple = struct.field(pytree_node=False)     # ((wrapS, wrapT), ...)
    filt: tuple = struct.field(pytree_node=False)     # ((mag, min_inner,
    #                                                     min_mip), ...)

    @classmethod
    def empty(cls) -> "TextureStack":
        return cls(texels=np.ones((1, 4), np.float32),
                   shapes=((1, 1),), wrap=((WRAP_REPEAT, WRAP_REPEAT),),
                   filt=((FILTER_LINEAR, FILTER_LINEAR, MIP_NONE),))

    @classmethod
    def from_images(cls, images, wrap=None, filt=None) -> "TextureStack":
        """Build from a list of [h, w, 4] float arrays (host, ingest-time).

        wrap: per-texture (wrapS, wrapT) or None => repeat.
        filt: per-texture (mag, min_inner, min_mip) or None => trilinear
        (the glTF default when the sampler leaves filters undefined).
        """
        images = [np.asarray(im, np.float32) for im in images]
        if not images:
            return cls.empty()
        shapes = tuple((im.shape[0], im.shape[1]) for im in images)
        n = len(images)
        wrap = tuple(tuple(w) for w in wrap) if wrap is not None else (
            ((WRAP_REPEAT, WRAP_REPEAT),) * n)
        filt = tuple(tuple(f) for f in filt) if filt is not None else (
            ((FILTER_LINEAR, FILTER_LINEAR, MIP_LINEAR),) * n)
        texels = np.concatenate([im.reshape(-1, 4) for im in images], axis=0)
        return cls(texels=texels, shapes=shapes, wrap=wrap, filt=filt)

    @property
    def num_textures(self) -> int:
        return len(self.shapes)

    @property
    def offsets(self) -> tuple:
        """Static start row of each texture in `texels`."""
        offs, acc = [], 0
        for (h, w) in self.shapes:
            offs.append(acc)
            acc += h * w
        return tuple(offs)

    def image(self, i: int) -> np.ndarray:
        """Host view of texture i as [h, w, 4] (tests / export)."""
        h, w = self.shapes[i]
        off = self.offsets[i]
        return np.asarray(self.texels[off:off + h * w]).reshape(h, w, 4)


@struct.dataclass
class EmitterTable:
    """Precomputed emissive-triangle table for next-event estimation.

    Radiance itself is NOT stored here — NEE reads
    materials.emissive_factor[mat] so emitter-radiance gradients flow; this
    table only holds the (detached) sampling distribution.
    """

    tri_idx: jnp.ndarray   # i32[E] triangle ids (padded with 0, masked)
    valid: jnp.ndarray     # bool[E]
    area: jnp.ndarray      # f32[E] world-space area
    pdf_tri: jnp.ndarray   # f32[E] discrete prob of picking each emitter
    cdf: jnp.ndarray       # f32[E] inclusive CDF over pdf_tri
    # Walker alias table over pdf_tri: O(1) emitter picks for emitter-rich
    # scenes (a ~7.8k-emitter visor pays ~13 dependent gather rounds per
    # NEE pass through searchsorted; the alias pick is 2 gathers).
    alias_prob: jnp.ndarray = None  # f32[E]
    alias_idx: jnp.ndarray = None   # i32[E]

    @classmethod
    def empty(cls) -> "EmitterTable":
        z = np.zeros((1,), np.float32)
        return cls(tri_idx=np.zeros((1,), np.int32),
                   valid=np.zeros((1,), bool),
                   area=z, pdf_tri=z, cdf=np.ones((1,), np.float32),
                   alias_prob=np.ones((1,), np.float32),
                   alias_idx=np.zeros((1,), np.int32))

    @property
    def num_emitters(self) -> int:
        return self.tri_idx.shape[0]


@struct.dataclass
class DirectionalLight:
    """Single directional 'sun' (also models the reference's headlight debug
    mode when direction tracks the camera, `assets/shaders/pbr/lighting.glsl:
    25-27` L = V)."""

    direction: jnp.ndarray  # f32[3] unit, points FROM light TOWARD scene
    radiance: jnp.ndarray   # f32[3]; zeros = disabled

    @classmethod
    def off(cls) -> "DirectionalLight":
        return cls(direction=np.array([0.0, -1.0, 0.0], np.float32),
                   radiance=np.zeros((3,), np.float32))


@struct.dataclass
class EnvMap:
    """Equirect HDR environment map with importance-sampling tables."""

    data: jnp.ndarray             # f32[H, W, 3] radiance
    conditional_cdf: jnp.ndarray  # f32[H, W] per-row inclusive CDF over x
    marginal_cdf: jnp.ndarray     # f32[H] inclusive CDF over rows
    pdf: jnp.ndarray              # f32[H, W] solid-angle pdf of each texel
    # Walker alias table over the texel distribution: O(1) sampling with 2
    # gathers instead of a 2-D CDF binary search (~13 dependent gathers).
    alias_prob: jnp.ndarray       # f32[H*W] acceptance threshold per slot
    alias_idx: jnp.ndarray        # i32[H*W] alias texel per slot

    @classmethod
    def constant(cls, radiance, height: int = 8, width: int = 16) -> "EnvMap":
        data = np.broadcast_to(np.asarray(radiance, np.float32),
                               (height, width, 3))
        return build_env_tables(data)


@struct.dataclass
class Scene:
    geometry: Geometry
    materials: Materials
    textures: TextureStack
    emitters: EmitterTable
    directional: DirectionalLight
    env: EnvMap | None
    # Optional acceleration structures; None => brute force.  Presence is
    # static (part of the pytree treedef), so integrators specialize at
    # trace time.  `clusters` (accel/clusters.py, the ray-stream path) wins
    # over `bvh` (accel/bvh.py XLA stack walk) when both are set.
    bvh: object | None = None
    clusters: object | None = None
    # Static (non-pytree) flags: let integrators skip whole light paths at
    # TRACE time (each saves a full shadow-ray sweep per bounce).
    has_emitters: bool = struct.field(pytree_node=False, default=False)
    has_directional: bool = struct.field(pytree_node=False, default=False)
    # True iff any material references a texture; False lets shading skip
    # every texture fetch statically (big win for untextured scenes).
    has_textures: bool = struct.field(pytree_node=False, default=False)
    # Which of the four texture slots (base_color, metallic_roughness,
    # normal, emissive) ANY material uses.  Static: shading skips the
    # fetches of entirely-absent slots at trace time — each saves 1-2
    # ray-sized quad gathers per bounce (a scene with only albedo+MR maps
    # pays zero for normal/emissive).
    tex_slots: tuple = struct.field(pytree_node=False,
                                    default=(False, False, False, False))
    # True iff every vertex normal equals its triangle's face normal
    # (checked at build).
    flat_normals: bool = struct.field(pytree_node=False, default=False)


def with_bvh(scene: "Scene", leaf_size: int | None = None) -> "Scene":
    """Build a BVH over the scene geometry (host; C++ builder when built,
    bit-identical numpy fallback otherwise) and attach it."""
    from ..accel.bvh import LEAF_SIZE
    from ..accel.native import build_bvh_fast
    bvh = build_bvh_fast(np.asarray(scene.geometry.positions),
                         np.asarray(scene.geometry.indices),
                         leaf_size=leaf_size or LEAF_SIZE)
    return scene.replace(bvh=bvh)


def with_clusters(scene: "Scene", k: int | None = None) -> "Scene":
    """Build the cluster grid (ray-stream tracer) and attach."""
    from ..accel.clusters import CLUSTER_K, pack_soup_host
    from ..accel.native import build_clusters_fast
    grid = build_clusters_fast(np.asarray(scene.geometry.positions),
                               np.asarray(scene.geometry.indices),
                               k=k or CLUSTER_K)
    grid = pack_soup_host(grid, np.asarray(scene.geometry.positions),
                          np.asarray(scene.geometry.indices))
    return scene.replace(clusters=grid)


def build_env_tables(data) -> EnvMap:
    """Build the 2D-CDF importance tables for an equirect env map.

    pdf is in solid-angle measure: p(omega) = p_img(x,y) * (H*W) / (2 pi^2
    sin(theta)).  Host-side numpy (ingest-time).  NOTE: when inverse
    rendering optimizes env.data the tables go stale, which is STILL an
    unbiased estimator (any positive sampling pdf works) as long as env.pdf
    matches the cdf tables actually sampled — both stay fixed together.
    """
    data = np.asarray(data, np.float32)
    h, w = data.shape[0], data.shape[1]
    lum = np.maximum(data.mean(axis=-1), 1e-12)
    # Weight rows by sin(theta) so the flat equirect oversampling of poles
    # is corrected in the sampling distribution.
    theta = (np.arange(h, dtype=np.float32) + 0.5) / h * np.pi
    sin_t = np.sin(theta).astype(np.float32)
    weighted = lum * sin_t[:, None]
    row_sums = weighted.sum(axis=1)
    total = max(row_sums.sum(), 1e-12)
    conditional_cdf = np.cumsum(weighted, axis=1) / np.maximum(
        row_sums[:, None], 1e-12)
    marginal_cdf = np.cumsum(row_sums) / total
    # image-space pdf -> solid-angle pdf
    p_img = weighted / total  # prob of each texel
    pdf_sa = p_img * (h * w) / (2.0 * np.pi * np.pi * np.maximum(
        sin_t[:, None], 1e-6))
    alias_prob, alias_idx = _build_alias_table(p_img.reshape(-1))
    return EnvMap(data=data,
                  conditional_cdf=conditional_cdf.astype(np.float32),
                  marginal_cdf=marginal_cdf.astype(np.float32),
                  pdf=pdf_sa.astype(np.float32),
                  alias_prob=alias_prob, alias_idx=alias_idx)


def _build_alias_table(p: np.ndarray):
    """Walker/Vose alias table for a discrete distribution p (sums to 1).

    Sampling: slot j ~ U{0..M-1}; return j if u < prob[j] else alias[j].
    Host-side O(M) build (ingest-time; see EnvMap.alias_*) — native C++
    when available (a 2048x1024 HDR is ~2M texels; the Python loop below
    is a multi-second stall at that size), same-algorithm Python fallback.
    """
    from ..accel.native import build_alias_native
    native = build_alias_native(p)
    if native is not None:
        return native
    p = np.asarray(p, np.float64)
    m = p.size
    scaled = p * m
    prob = np.ones(m, np.float64)
    alias = np.arange(m, dtype=np.int64)
    small = [i for i in range(m) if scaled[i] < 1.0]
    large = [i for i in range(m) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    # Leftovers (float slop) keep prob = 1 (self-alias).
    return prob.astype(np.float32), alias.astype(np.int32)


def build_emitter_table(geometry, materials, pad_to: int | None = None,
                        np_mod=np) -> EmitterTable:
    """Host-side scan for emissive triangles -> sampling table.

    Power-weighted discrete distribution (area x luminance of
    emissive_factor); probabilities are detached by construction (numpy).
    """
    pos = np.asarray(geometry.positions)
    idx = np.asarray(geometry.indices)
    tri_mat = np.asarray(geometry.tri_material)
    emissive = np.asarray(materials.emissive_factor)

    v0, v1, v2 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=-1)
    lum = emissive[tri_mat] @ np.array([0.2126, 0.7152, 0.0722], np.float32)
    power = area * np.maximum(lum, 0.0)
    ids = np.nonzero(power > 0.0)[0].astype(np.int32)

    if ids.size == 0:
        return EmitterTable.empty()

    e = ids.size
    cap = pad_to or e
    assert cap >= e
    tri_idx = np.zeros((cap,), np.int32)
    tri_idx[:e] = ids
    valid = np.zeros((cap,), bool)
    valid[:e] = True
    areas = np.zeros((cap,), np.float32)
    areas[:e] = area[ids]
    p = np.zeros((cap,), np.float32)
    p[:e] = power[ids] / power[ids].sum()
    cdf = np.cumsum(p)
    cdf[e - 1:] = 1.0
    alias_prob, alias_idx = _build_alias_table(p)
    return EmitterTable(tri_idx=tri_idx, valid=valid, area=areas, pdf_tri=p,
                        cdf=cdf.astype(np.float32),
                        alias_prob=alias_prob, alias_idx=alias_idx)


def upload_scene(scene: Scene, device=None, sharding=None) -> Scene:
    """Stage the whole host-built scene arena to device in ONE transfer
    batch (the TransferStager analog, reference `TransferStager.cpp:51-172`:
    one staging allocation, one submission).  Pass a NamedSharding to
    replicate across a mesh."""
    target = sharding if sharding is not None else (
        device or jax.devices()[0])
    return jax.device_put(scene, target)


def make_scene(geometry: Geometry, materials: Materials,
               textures: TextureStack | None = None,
               directional: DirectionalLight | None = None,
               env: EnvMap | None = None) -> Scene:
    """Assemble a Scene, deriving the emitter table from emissive materials."""
    emitters = build_emitter_table(geometry, materials)
    has_emitters = bool(np.asarray(emitters.valid).any())
    directional = (directional if directional is not None
                   else DirectionalLight.off())
    pos = np.asarray(geometry.positions)
    idx = np.asarray(geometry.indices)
    fn = np.cross(pos[idx[:, 1]] - pos[idx[:, 0]],
                  pos[idx[:, 2]] - pos[idx[:, 0]])
    fn = fn / np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-20)
    nrm = np.asarray(geometry.normals)
    flat = bool(all(np.allclose(fn, nrm[idx[:, k]], atol=1e-5)
                    for k in range(3)))
    slots = tuple(bool((np.asarray(t) >= 0).any()) for t in (
        materials.base_color_tex, materials.metallic_roughness_tex,
        materials.normal_tex, materials.emissive_tex))
    return Scene(
        geometry=geometry,
        materials=materials,
        textures=textures if textures is not None else TextureStack.empty(),
        emitters=emitters,
        directional=directional,
        env=env,
        has_emitters=has_emitters,
        has_directional=bool(np.asarray(directional.radiance).sum() > 0),
        has_textures=any(slots),
        tex_slots=slots,
        flat_normals=flat,
    )
