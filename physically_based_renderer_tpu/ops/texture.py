"""Texture filtering: quad-packed mip pyramid + single-gather sampling.

Replaces the reference's vk::Sampler + combined-image-sampler descriptors
(`src/pbr_engine/engine/pbr/Material.cpp:25-62`, sampler creation
`PbrRenderSystem.cpp:96-121`): wrap modes AND min/mag/mip filters from the
glTF sampler are honored (the round-3 version ignored filters and had no
mip chain).

Performance shape (the whole point of this layout): a ray-sized row gather
costs about the same per gather op whatever the row width, so a classic
bilinear fetch (4 corner gathers + 1 metadata gather) is 5x the price of
one gather.  Here every texel row of every mip level is stored
QUAD-PACKED — row (l, y, x) holds the 2x2 neighborhood
[c(y,x) | c(y,x+1) | c(y+1,x) | c(y+1,x+1)] with the +1 wrap baked in at
pack time — so:

  * bilinear        = ONE [N, 16] row gather + VPU lerps;
  * trilinear (mip) = TWO row gathers (levels l, l+1);
  * metadata        = ZERO gathers: per-texture shape/wrap/filter/offset is
    STATIC (scene.types.TextureStack) and rides the per-triangle attribute
    row (integrator/shading.pack_tri_attrs), which shading gathers anyway.

Memory: 4x texels (quad duplication) summed over mip levels (x4/3) — e.g.
a 2048x1024 RGBA stack costs ~180 MB, irrelevant next to 16 GB HBM, and
the flat arena removes the old pad-everything-to-global-max stack.

Differentiability: the pyramid (mip chain + quad pack) is built INSIDE jit
from `stack.texels` with plain jnp ops, so texture-recovery gradients flow
through filtering back to the texel arena (grad/inverse.py).

Mirror wrap folds the continuous coordinate (u' = 1 - |1 - u mod 2|), which
matches hardware except within half a texel of the u=0 fold seam.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..scene.types import (FILTER_NEAREST, MIP_LINEAR, MIP_NONE,
                           TextureStack, WRAP_CLAMP, WRAP_MIRROR,
                           WRAP_REPEAT)
from .gather import take_rows

L_MAX = 13       # supports textures up to 8192 on the long side
META_W = 9       # meta row: off0 h0 w0 wrapS wrapT mag min_inner min_mip nl


def _levels(h: int, w: int, min_mip: int) -> list[tuple[int, int]]:
    """Static mip-level dims for a texture: [(h0,w0), (h1,w1), ...]."""
    if min_mip == MIP_NONE:
        return [(h, w)]
    dims = [(h, w)]
    while max(h, w) > 1:
        h, w = max(1, h // 2), max(1, w // 2)
        dims.append((h, w))
    return dims


def texture_meta(stack: TextureStack) -> np.ndarray:
    """Static per-texture metadata table f32[T, META_W].

    off0 is the texture's level-0 row offset into the PYRAMID's quad arena
    (levels of one texture are contiguous, nearest first).  All values are
    small ints stored exactly in f32 (offsets < 2^24 rows asserted).
    """
    rows = []
    off = 0
    for (h, w), (ws, wt), (mag, mi, mm) in zip(stack.shapes, stack.wrap,
                                               stack.filt):
        dims = _levels(h, w, mm)
        rows.append([off, h, w, ws, wt, mag, mi, mm, len(dims)])
        off += sum(hl * wl for hl, wl in dims)
    assert off < (1 << 24), "texture pyramid exceeds exact-f32 addressing"
    return np.asarray(rows, np.float32)


def _shift_x(img: jnp.ndarray, wrap: int) -> jnp.ndarray:
    """img[y, x] -> img[y, wrap(x+1)] (the baked +1 neighbor)."""
    if wrap == WRAP_REPEAT:
        return jnp.roll(img, -1, axis=1)
    # clamp; mirror's +1 neighbor at the far edge is also the edge texel
    return jnp.concatenate([img[:, 1:], img[:, -1:]], axis=1)


def _shift_y(img: jnp.ndarray, wrap: int) -> jnp.ndarray:
    if wrap == WRAP_REPEAT:
        return jnp.roll(img, -1, axis=0)
    return jnp.concatenate([img[1:], img[-1:]], axis=0)


def _downsample(img: jnp.ndarray) -> jnp.ndarray:
    """2x2 box filter [h,w,c] -> [max(1,h//2), max(1,w//2), c].

    Odd dims are edge-padded to even first (slight edge overweight — the
    standard cheap approximation)."""
    h, w = img.shape[0], img.shape[1]
    if h > 1 and h % 2:
        img = jnp.concatenate([img, img[-1:]], axis=0)
    if w > 1 and w % 2:
        img = jnp.concatenate([img, img[:, -1:]], axis=1)
    h2, w2 = max(1, h // 2), max(1, w // 2)
    if h == 1:
        return img.reshape(1, w2, 2, -1).mean(axis=2)
    if w == 1:
        return img.reshape(h2, 2, 1, -1).mean(axis=1)
    return img.reshape(h2, 2, w2, 2, -1).mean(axis=(1, 3))


def _quad_pack(img: jnp.ndarray, ws: int, wt: int) -> jnp.ndarray:
    """[h,w,4] -> [h*w, 16] quad rows (c00 | c10 | c01 | c11)."""
    nx = _shift_x(img, ws)
    ny = _shift_y(img, wt)
    nxy = _shift_y(nx, wt)
    q = jnp.concatenate([img, nx, ny, nxy], axis=-1)
    return q.reshape(-1, 16)


@struct.dataclass
class TexturePyramid:
    """Render-time derived form of a TextureStack (built inside jit)."""

    quads: jnp.ndarray  # f32[RQ, 16] quad rows, all (texture, level)s


def build_pyramid(stack: TextureStack) -> TexturePyramid:
    """Mip chain + quad pack for every texture (differentiable, in-jit).

    XLA CSEs repeated calls within one trace; integrators build it once per
    sample alongside pack_tri_attrs."""
    pieces = []
    offs = stack.offsets
    for i, ((h, w), (ws, wt), (mag, mi, mm)) in enumerate(
            zip(stack.shapes, stack.wrap, stack.filt)):
        img = stack.texels[offs[i]:offs[i] + h * w].reshape(h, w, 4)
        for (hl, wl) in _levels(h, w, mm):
            if (hl, wl) != img.shape[:2]:
                img = _downsample(img)
            pieces.append(_quad_pack(img, ws, wt))
    return TexturePyramid(quads=jnp.concatenate(pieces, axis=0))


def _wrap_u(u: jnp.ndarray, mode: jnp.ndarray) -> jnp.ndarray:
    """Continuous texture-coordinate wrap (mirror folds, clamp defers to the
    per-level texel clip, repeat defers to the integer mod)."""
    mirrored = 1.0 - jnp.abs(1.0 - jnp.mod(u, 2.0))
    return jnp.where(mode == WRAP_MIRROR, mirrored, u)


def _fetch_level(quads, meta, u, v, l):
    """One quad gather at per-ray level l -> (quad f32[N,16], fx, fy)."""
    off0, h0, w0 = meta[:, 0], meta[:, 1], meta[:, 2]
    ws, wt = meta[:, 3], meta[:, 4]
    # level dims + offset, exact small-int f32 math
    scale = jnp.exp2(-l)
    hl = jnp.maximum(1.0, jnp.floor(h0 * scale))
    wl = jnp.maximum(1.0, jnp.floor(w0 * scale))
    off = off0
    for j in range(L_MAX - 1):
        hj = jnp.maximum(1.0, jnp.floor(h0 * (0.5 ** j)))
        wj = jnp.maximum(1.0, jnp.floor(w0 * (0.5 ** j)))
        off = off + jnp.where(j < l, hj * wj, 0.0)
    x = u * wl - 0.5
    y = v * hl - 0.5
    # clamp wraps the continuous coordinate (exact, incl. the border lerp)
    x = jnp.where(ws == WRAP_CLAMP, jnp.clip(x, 0.0, wl - 1.0), x)
    y = jnp.where(wt == WRAP_CLAMP, jnp.clip(y, 0.0, hl - 1.0), y)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = jnp.where(ws == WRAP_REPEAT, jnp.mod(x0, wl),
                   jnp.clip(x0, 0.0, wl - 1.0))
    y0 = jnp.where(wt == WRAP_REPEAT, jnp.mod(y0, hl),
                   jnp.clip(y0, 0.0, hl - 1.0))
    idx = (off + y0 * wl + x0).astype(jnp.int32)
    return take_rows(quads, idx), fx[:, None], fy[:, None]


def _lerp_quad(q, fx, fy, nearest):
    """Bilinear (or snapped-nearest) blend of one quad row [N,16]->[N,4]."""
    fx = jnp.where(nearest, (fx >= 0.5).astype(jnp.float32), fx)
    fy = jnp.where(nearest, (fy >= 0.5).astype(jnp.float32), fy)
    top = q[:, 0:4] * (1.0 - fx) + q[:, 4:8] * fx
    bot = q[:, 8:12] * (1.0 - fx) + q[:, 12:16] * fx
    return top * (1.0 - fy) + bot * fy


def sample_slot(pyr: TexturePyramid, meta: jnp.ndarray, uv: jnp.ndarray,
                lod: jnp.ndarray | None = None, default=1.0,
                trilinear: bool = True) -> jnp.ndarray:
    """Sample one texture slot -> f32[N, 4].

    meta f32[N, META_W] per-ray metadata rows (texture_meta rows routed
    through the material/triangle tables; off0 < 0 means "no texture" and
    the lane returns `default`).  uv f32[N,2].  lod f32[N] = log2 of the
    ray's footprint in WORLD units x uv_density (texture-size term added
    here); None disables mip selection (level-0 bilinear).

    trilinear=False statically drops the second gather (callers may force
    it when no texture in the stack has MIP_LINEAR).
    """
    has = meta[:, 0] >= 0.0
    safe = jnp.where(has[:, None], meta, 0.0)
    h0, w0 = safe[:, 1], safe[:, 2]
    mag, mi, mm = safe[:, 5], safe[:, 6], safe[:, 7]
    nl = jnp.maximum(safe[:, 8], 1.0)
    u = _wrap_u(uv[:, 0], safe[:, 3])
    v = _wrap_u(uv[:, 1], safe[:, 4])

    if lod is None:
        l0 = jnp.zeros_like(h0)
        frac = 0.0
        minify = jnp.zeros_like(has)
        tri = False
    else:
        # add the texture-size term: footprint_texels = footprint * sqrt(hw)
        ll = lod + 0.5 * jnp.log2(jnp.maximum(h0 * w0, 1.0))
        minify = ll > 0.0
        lmax = nl - 1.0
        lc = jnp.clip(ll, 0.0, lmax)
        # MIP_NEAREST snaps; MIP_NONE has nl=1 so lc=0 naturally
        l0 = jnp.where(mm == MIP_LINEAR, jnp.floor(lc), jnp.round(lc))
        frac = jnp.where((mm == MIP_LINEAR) & (l0 < lmax), lc - l0,
                         0.0)[:, None]
        tri = trilinear

    nearest = jnp.where(minify, mi == FILTER_NEAREST,
                        mag == FILTER_NEAREST)[:, None]
    q0, fx, fy = _fetch_level(pyr.quads, safe, u, v, l0)
    out = _lerp_quad(q0, fx, fy, nearest)
    if tri:
        l1 = jnp.minimum(l0 + 1.0, nl - 1.0)
        q1, fx1, fy1 = _fetch_level(pyr.quads, safe, u, v, l1)
        out = out * (1.0 - frac) + _lerp_quad(q1, fx1, fy1, nearest) * frac
    dflt = jnp.broadcast_to(jnp.asarray(default, jnp.float32), out.shape)
    return jnp.where(has[:, None], out, dflt)


def sample_bilinear(stack: TextureStack, tex_idx: jnp.ndarray,
                    uv: jnp.ndarray, default: float = 1.0) -> jnp.ndarray:
    """Level-0 bilinear by texture index -> f32[N, 4] (tests / tools; the
    integrator uses sample_slot with metadata riding the attribute row).

    tex_idx i32[N]; entries < 0 return `default`."""
    pyr = build_pyramid(stack)
    meta_tab = jnp.asarray(texture_meta(stack))
    rows = take_rows(meta_tab, jnp.maximum(tex_idx, 0))
    rows = jnp.where((tex_idx >= 0)[:, None], rows, -1.0)
    return sample_slot(pyr, rows, uv, lod=None, default=default)


def env_quads(data: jnp.ndarray) -> jnp.ndarray:
    """Quad-pack an equirect env map [H, W, 3] -> f32[H*W, 12]
    (x wraps/repeat across the phi seam, y clamps at the poles)."""
    nx = jnp.roll(data, -1, axis=1)
    ny = jnp.concatenate([data[1:], data[-1:]], axis=0)
    nxy = jnp.roll(ny, -1, axis=1)
    return jnp.concatenate([data, nx, ny, nxy], axis=-1).reshape(-1, 12)


def sample_env_bilinear(data: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Equirect env-map lookup for unit directions d[N,3] -> radiance [N,3].

    theta = acos(y) maps to rows (0 = +y pole), phi = atan2(z, x) to
    columns.  ONE quad-row gather per call (quad pack is in-jit + CSE'd)."""
    h, w = data.shape[0], data.shape[1]
    q = env_quads(data)
    theta = jnp.arccos(jnp.clip(d[:, 1], -1.0, 1.0))
    phi = jnp.arctan2(d[:, 2], d[:, 0])
    x = (phi / (2.0 * jnp.pi) + 0.5) * w - 0.5
    y = jnp.clip(theta / jnp.pi * h - 0.5, 0.0, h - 1.0)
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    x0 = jnp.mod(x0, w)
    idx = (y0 * w + x0).astype(jnp.int32)
    rows = take_rows(q, idx)
    top = rows[:, 0:3] * (1.0 - fx) + rows[:, 3:6] * fx
    bot = rows[:, 6:9] * (1.0 - fx) + rows[:, 9:12] * fx
    return top * (1.0 - fy) + bot * fy
