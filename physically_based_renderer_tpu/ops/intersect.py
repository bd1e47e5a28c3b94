"""Ray-triangle intersection ops (jnp reference path + chunked closest-hit).

This is the replacement for the reference's fixed-function
rasterizer+depth-test visibility (geometry pass,
`src/pbr_engine/engine/pbr/PbrRenderSystem.cpp:367-465`): instead of
rasterizing triangles into a G-buffer, rays query the triangle soup directly
(Moller-Trumbore).  The brute-force closest-hit below is the correctness
oracle for the BVH (accel/) and is itself the production path for small
scenes (Cornell-box class), where testing all T triangles per ray in a
single fused elementwise sweep beats any tree walk.

Design notes:
  * rays x tris is evaluated in TRIANGLE CHUNKS with a running best-hit so
    peak memory is N_rays x CHUNK, fully fused elementwise work, no
    data-dependent control flow.
  * everything is differentiable: hit t/u/v carry gradients to vertex
    positions (the continuous part of the visibility function).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from ..core import struct

BIG = 1e30


@struct.dataclass
class Hit:
    """Closest-hit record, SoA over rays."""

    t: jnp.ndarray    # f32[N] distance (BIG when miss)
    tri: jnp.ndarray  # i32[N] triangle index (-1 when miss)
    u: jnp.ndarray    # f32[N] barycentric of v1
    v: jnp.ndarray    # f32[N] barycentric of v2

    @property
    def miss(self) -> jnp.ndarray:
        return self.tri < 0

    @property
    def w(self) -> jnp.ndarray:
        return 1.0 - self.u - self.v


def _moller_trumbore(o, d, v0, v1, v2, t_min, t_max, eps=1e-9):
    """Intersect rays [N,3] against tris [T,3] pairwise -> (t, u, v, valid)
    each [N, T].  Watertight enough for test scenes; BACKFACES ARE HIT
    (double-sided, unlike the raster reference's back-face cull
    `PbrRenderSystem.cpp:181` — a path tracer needs interior hits)."""
    e1 = v1 - v0  # [T,3]
    e2 = v2 - v0
    p = jnp.cross(d[:, None, :], e2[None, :, :])          # [N,T,3]
    det = jnp.sum(p * e1[None], axis=-1)                  # [N,T]
    inv_det = jnp.where(jnp.abs(det) > eps, 1.0 / det, 0.0)
    tv = o[:, None, :] - v0[None]                          # [N,T,3]
    u = jnp.sum(tv * p, axis=-1) * inv_det
    q = jnp.cross(tv, e1[None, :, :])
    v = jnp.sum(d[:, None, :] * q, axis=-1) * inv_det
    t = jnp.sum(e2[None] * q, axis=-1) * inv_det
    valid = ((jnp.abs(det) > eps) & (u >= 0.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t > t_min) & (t < t_max))
    return t, u, v, valid


def intersect_brute(o: jnp.ndarray, d: jnp.ndarray, v0, v1, v2,
                    t_min: float = 1e-4, t_max: float = BIG,
                    chunk: int = 1024) -> Hit:
    """Closest hit of rays [N,3] against all T triangles, chunked over T."""
    n = o.shape[0]
    num_tris = v0.shape[0]
    chunk = min(chunk, max(num_tris, 1))
    pad = (-num_tris) % chunk
    if pad:
        padv = jnp.full((pad, 3), 2.0 * BIG, v0.dtype)
        v0 = jnp.concatenate([v0, padv])
        v1 = jnp.concatenate([v1, padv])
        v2 = jnp.concatenate([v2, padv])
    num_chunks = v0.shape[0] // chunk
    v0c = v0.reshape(num_chunks, chunk, 3)
    v1c = v1.reshape(num_chunks, chunk, 3)
    v2c = v2.reshape(num_chunks, chunk, 3)

    # Derive the carry init from `d` so it inherits the rays' varying-axis
    # set: under shard_map(check_vma=True) a constant-built carry would
    # clash with the varying per-chunk update.  (`d` not `o`: primary-ray
    # origins are the replicated camera position, directions always vary.)
    zero = d[:, 0] * 0.0
    init = Hit(t=zero + BIG,
               tri=zero.astype(jnp.int32) - 1,
               u=zero,
               v=zero)

    def body(best: Hit, args):
        ci, a0, a1, a2 = args
        t, u, v, valid = _moller_trumbore(o, d, a0, a1, a2, t_min, t_max)
        t = jnp.where(valid, t, BIG)
        j = jnp.argmin(t, axis=-1)                      # [N] best in chunk
        rows = jnp.arange(n)
        tj = t[rows, j]
        better = tj < best.t
        new = Hit(
            t=jnp.where(better, tj, best.t),
            tri=jnp.where(better, (ci * chunk + j).astype(jnp.int32),
                          best.tri),
            u=jnp.where(better, u[rows, j], best.u),
            v=jnp.where(better, v[rows, j], best.v),
        )
        return new, None

    idx = jnp.arange(num_chunks)
    best, _ = jax.lax.scan(body, init, (idx, v0c, v1c, v2c))
    return best


def occluded_brute(o: jnp.ndarray, d: jnp.ndarray, v0, v1, v2,
                   t_min: float = 1e-4, t_max: float | jnp.ndarray = BIG,
                   chunk: int = 1024) -> jnp.ndarray:
    """Any-hit (shadow ray) query -> bool[N]. t_max may be per-ray [N]."""
    n = o.shape[0]
    num_tris = v0.shape[0]
    chunk = min(chunk, max(num_tris, 1))
    pad = (-num_tris) % chunk
    if pad:
        padv = jnp.full((pad, 3), 2.0 * BIG, v0.dtype)
        v0 = jnp.concatenate([v0, padv])
        v1 = jnp.concatenate([v1, padv])
        v2 = jnp.concatenate([v2, padv])
    num_chunks = v0.shape[0] // chunk
    v0c = v0.reshape(num_chunks, chunk, 3)
    v1c = v1.reshape(num_chunks, chunk, 3)
    v2c = v2.reshape(num_chunks, chunk, 3)
    t_max_arr = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    def body(occ, args):
        a0, a1, a2 = args
        _, _, _, valid = _moller_trumbore(
            o, d, a0, a1, a2, t_min, t_max_arr[:, None])
        return occ | jnp.any(valid, axis=-1), None

    # Varying-aware init (see intersect_brute).
    occ0 = (d[:, 0] * 0.0) > 1.0
    occ, _ = jax.lax.scan(body, occ0, (v0c, v1c, v2c))
    return occ
