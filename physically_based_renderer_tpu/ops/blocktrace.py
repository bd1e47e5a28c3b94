"""Block-stream tracer: coherence-exploiting intersection.

Per-ray traversal needs per-ray gathers and divergent control flow, and
per-ray compaction (`jnp.nonzero`) needs dynamic shapes.  This tracer has
neither: rays are processed in BLOCKS of B (spatially coherent camera rays
in morton order; bounce and shadow rays sorted by direction bin inside the
call):

  phase A (`_select_candidates`): per block, a conservative interval-
     arithmetic slab test of the ray BUNDLE (origin box x direction box)
     against the cluster AABBs — hierarchically through parent boxes for
     cluster-rich grids — and the U nearest overlapping clusters by
     lax.top_k, with each candidate's conservative entry distance;
  phase B: intersect the block's rays with the triangles of its candidates,
     nearest first.  Two implementations share phase A:
       "xla"    — `_phase_b_xla`: chunks of candidates as dense
                  [NB, B, chunk*K] Moller-Trumbore, up to the largest
                  candidate count of any block;
       "triton" — ops/pallas_trace.py: a Pallas kernel (Triton route) that
                  walks each tile's candidates and exits early.
  finish: winner decode, then either a detached Hit (`lean`, for callers
     that re-derive attached data, integrator/shading.py) or the attached
     re-intersection on the winning triangle, so vertex gradients flow.

Correctness cap: a block needing more than U clusters drops the farthest
ones — misses are possible for extremely incoherent blocks.  U is
configurable (RenderConfig.max_u).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..accel.clusters import ClusterGrid, pack_soup
from .intersect import BIG, Hit

sg = jax.lax.stop_gradient

KERNELS = ("xla", "triton")
XLA_CHUNK = 8   # candidates per step of the XLA phase B


def bucket_sort_perm(key: jnp.ndarray, n_buckets: int) -> jnp.ndarray:
    """Stable counting-sort permutation for small integer keys [N].

    A one-hot cumsum + one scatter build the stable permutation; the
    [N, n_buckets] one-hot scales linearly in the bucket count, which is a
    few tens here.  Returns perm with key[perm] sorted ascending, stable.
    """
    n = key.shape[0]
    onehot = (key[:, None] == jnp.arange(n_buckets)).astype(jnp.int32)
    within = jnp.cumsum(onehot, axis=0) - onehot      # exclusive in-bucket
    counts = jnp.sum(onehot, axis=0)                  # [B]
    offsets = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                               jnp.cumsum(counts)[:-1].astype(jnp.int32)])
    pos = (jnp.sum(within * onehot, axis=1)
           + offsets[jnp.clip(key, 0, n_buckets - 1)])
    return jnp.zeros((n,), jnp.int32).at[pos].set(jnp.arange(n,
                                                             dtype=jnp.int32))


def _root_cull(grid: "ClusterGrid", o, d, t_min, t_max_arr):
    """Per-ray slab test against the ROOT AABB (union of cluster boxes).

    Rays that cannot touch the scene get t_max = 0: they become dead lanes
    that (a) collapse out of every block's bundle bounds, (b) drop out of
    the kernel's live-lane early exit, and (c) make all-sky blocks skip at
    n_valid = 0.  Rays that do enter have t_max clipped to the (inflated)
    box EXIT distance — any legitimate hit lies inside the root box, and a
    finite t_max lets closest-hit blocks exit as soon as every live lane's
    best beats the next candidate's entry.
    """
    lo = jnp.min(grid.aabb_min, axis=0)
    hi = jnp.max(grid.aabb_max, axis=0)
    inv = jnp.where(d >= 0.0, 1.0, -1.0) / jnp.maximum(jnp.abs(d), 1e-12)
    t0 = (lo[None, :] - o) * inv
    t1 = (hi[None, :] - o) * inv
    near = jnp.minimum(t0, t1).max(axis=-1)
    far = jnp.maximum(t0, t1).min(axis=-1)
    far_inf = far * 1.0001 + 1e-4          # fp-safety inflation
    hit = (near <= far_inf) & (far_inf >= t_min) & (near <= t_max_arr)
    return jnp.where(hit, jnp.minimum(t_max_arr, far_inf), 0.0)


def dir_bin(d) -> jnp.ndarray:
    """Direction coherence bin in [0, 24): octant (3 sign bits) x dominant
    axis.  Within a bin all components share sign AND the same axis
    dominates, bounding the bundle to a ~54-degree cone — the interval
    slab test culls far better than with raw 90-degree octants."""
    octant = ((d[:, 0] < 0).astype(jnp.int32) * 4
              + (d[:, 1] < 0).astype(jnp.int32) * 2
              + (d[:, 2] < 0).astype(jnp.int32))
    ad = jnp.abs(d)
    dom = jnp.where(ad[:, 0] >= jnp.maximum(ad[:, 1], ad[:, 2]), 0,
                    jnp.where(ad[:, 1] >= ad[:, 2], 1, 2))
    return octant * 3 + dom


def _octant_perm(d, t_max_arr):
    """Stable permutation sorting rays by (dead, direction bin).

    Keeps the caller's position-coherent (morton) order WITHIN each bucket,
    so blocks get cone-coherent direction bundles without losing origin
    locality — exactly what the interval slab test feeds on.  Dead lanes
    (t_max = 0) pack into trailing all-dead blocks that phase B skips.
    """
    key = jnp.where(t_max_arr > 0.0, dir_bin(d), 24)
    return bucket_sort_perm(key, 25)


def _interval_slab(amin, amax, o_lo, o_hi, iv_lo, iv_hi, t_min, t_max_hi):
    """Conservative bundle-vs-AABB test.

    amin/amax: [C,3] shared boxes or [NB,M,3] per-block boxes; o_lo/o_hi:
    [NB,3] origin bounds; iv_lo/iv_hi: [NB,3] inverse-direction bounds;
    t_max_hi: [NB] largest t_max in block.
    Returns (overlap [NB,C|M], entry_lo [NB,C|M] conservative nearest entry).
    """
    def prod_bounds(a):  # a: [NB,C,3] interval times inv interval
        c1 = a * iv_lo[:, None, :]
        c2 = a * iv_hi[:, None, :]
        return jnp.minimum(c1, c2), jnp.maximum(c1, c2)

    # (amin - o) spans [amin - o_hi, amin - o_lo]
    a_lo = amin - o_hi[:, None, :]
    a_hi = amin - o_lo[:, None, :]
    b_lo = amax - o_hi[:, None, :]
    b_hi = amax - o_lo[:, None, :]
    # interval product: min/max over the 4 corner products
    t0l1, t0h1 = prod_bounds(a_lo)
    t0l2, t0h2 = prod_bounds(a_hi)
    t0_lo = jnp.minimum(t0l1, t0l2)
    t0_hi = jnp.maximum(t0h1, t0h2)
    t1l1, t1h1 = prod_bounds(b_lo)
    t1l2, t1h2 = prod_bounds(b_hi)
    t1_lo = jnp.minimum(t1l1, t1l2)
    t1_hi = jnp.maximum(t1h1, t1h2)
    # slab near/far, conservatively widened
    near_lo = jnp.minimum(t0_lo, t1_lo).max(axis=-1)   # [NB,C]
    far_hi = jnp.maximum(t0_hi, t1_hi).min(axis=-1)
    overlap = (near_lo <= far_hi) & (far_hi >= t_min) & (
        near_lo <= t_max_hi[:, None])
    return overlap, jnp.maximum(near_lo, 0.0)


def _round_up(x, m):
    return -(-x // m) * m


def _select_candidates(grid, ob, db, tmb, t_min, max_u):
    """Phase A: per-block interval culling + nearest-first top-U.

    ob/db [NB, B, 3], tmb [NB, B] (t_max = 0 marks a dead lane).  Returns
    (u_idx i32[NB, U], u_entry f32[NB, U], n_valid i32[NB]): valid
    candidates come first (sorted by conservative entry distance); invalid
    slots hold the sentinel cluster index C and entry BIG.

    Cluster-rich grids go HIERARCHICAL: slab + top_k over the 4x smaller
    parent boxes, arithmetic expansion to the 4 consecutive children per
    parent, exact child slab, then a small nearest-first top_k over the
    expanded list — a flat top_k over thousands of clusters costs more than
    the culling saves."""
    c = grid.num_clusters
    nb = ob.shape[0]
    inv = jnp.where(db >= 0.0, 1.0, -1.0) / jnp.maximum(jnp.abs(db), 1e-12)
    lane_valid = (tmb > 0.0)[..., None]
    o_ref = ob[:, :1, :]
    ob_m = jnp.where(lane_valid, ob, o_ref)
    inv_m = jnp.where(lane_valid, inv, inv[:, :1, :])
    o_lo, o_hi = ob_m.min(1), ob_m.max(1)
    iv_lo, iv_hi = inv_m.min(1), inv_m.max(1)
    tm_hi = tmb.max(1)

    hierarchical = (grid.parent_min is not None and c > 4 * max_u)
    if hierarchical:
        n_par = grid.parent_min.shape[0]
        ov_p, en_p = _interval_slab(grid.parent_min, grid.parent_max,
                                    o_lo, o_hi, iv_lo, iv_hi, t_min, tm_hi)
        n_sel = min(max(max_u // 2, 8), n_par)
        _, p_idx = jax.lax.top_k(jnp.where(ov_p, -en_p, -jnp.inf), n_sel)
        p_valid = jnp.take_along_axis(ov_p, p_idx, axis=1)   # [NB, NP]
        child = (p_idx[:, :, None] * 4
                 + jnp.arange(4, dtype=p_idx.dtype)).reshape(nb, -1)
        c_ok = (child < c) & jnp.repeat(p_valid, 4, axis=1)
        safe = jnp.minimum(child, c - 1)
        # per-block child slab (same interval math, boxes now per block)
        overlap, entry = _interval_slab(
            grid.aabb_min[safe], grid.aabb_max[safe], o_lo, o_hi, iv_lo,
            iv_hi, t_min, tm_hi)
        overlap = overlap & c_ok
        _, s_idx = jax.lax.top_k(jnp.where(overlap, -entry, -jnp.inf),
                                 min(max_u, overlap.shape[1]))
        u_idx = jnp.take_along_axis(child, s_idx, axis=1)
    else:
        overlap, entry = _interval_slab(
            grid.aabb_min, grid.aabb_max, o_lo, o_hi, iv_lo, iv_hi,
            t_min, tm_hi)
        _, s_idx = jax.lax.top_k(jnp.where(overlap, -entry, -jnp.inf),
                                 min(max_u, c))
        u_idx = s_idx
    u_valid = jnp.take_along_axis(overlap, s_idx, axis=1)
    u_entry = jnp.where(u_valid, jnp.take_along_axis(entry, s_idx, axis=1),
                        BIG)
    n_valid = jnp.sum(u_valid, axis=1).astype(jnp.int32)
    u_idx = jnp.where(u_valid, u_idx, c)                  # sentinel
    return u_idx.astype(jnp.int32), u_entry, n_valid


def _phase_b_xla(u_idx, n_valid, ob, db, tmb, soup, t_min, any_hit):
    """Phase B in plain XLA: chunks of XLA_CHUNK candidates as one dense
    [NB, B, chunk*K] Moller-Trumbore + reduction per step, for as many
    steps as the largest candidate count of any block.  Same outputs as
    ops/pallas_trace.trace_blocks_triton."""
    nb, n_u = u_idx.shape
    c, _, k = soup.shape
    ch = min(XLA_CHUNK, n_u)
    u_pad = jnp.pad(u_idx, ((0, 0), (0, _round_up(n_u, ch) - n_u)),
                    constant_values=c)
    rox, roy, roz = (ob[..., i:i + 1] for i in range(3))    # [NB, B, 1]
    rdx, rdy, rdz = (db[..., i:i + 1] for i in range(3))
    rtm = tmb[..., None]

    def step(uc, carry):
        best_t, best_flat, occ = carry
        sl = jax.lax.dynamic_slice_in_dim(u_pad, uc * ch, ch, 1)   # [NB,ch]
        rows = soup[jnp.minimum(sl, c - 1)]                   # [NB,ch,9,K]
        rows = jnp.moveaxis(rows, 2, 1).reshape(nb, 9, 1, ch * k)
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
            rows[:, i] for i in range(9))                     # [NB,1,W]
        slot = uc * ch + jnp.arange(ch)
        valid = jnp.repeat(slot[None, :] < n_valid[:, None], k,
                           axis=1)[:, None, :]                # [NB,1,W]
        px = rdy * e2z - rdz * e2y
        py = rdz * e2x - rdx * e2z
        pz = rdx * e2y - rdy * e2x
        det = px * e1x + py * e1y + pz * e1z
        inv = jnp.where(jnp.abs(det) > 1e-9, 1.0 / det, 0.0)
        tx, ty, tz = rox - v0x, roy - v0y, roz - v0z
        uu = (tx * px + ty * py + tz * pz) * inv
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        vv = (rdx * qx + rdy * qy + rdz * qz) * inv
        tt = (e2x * qx + e2y * qy + e2z * qz) * inv
        ok = (valid & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
              & (tt > t_min) & (tt < rtm))                    # [NB,B,W]
        if any_hit:
            return best_t, best_flat, occ | jnp.any(ok, axis=-1)
        tt = jnp.where(ok, tt, BIG)
        kb = jnp.argmin(tt, axis=-1)                          # [NB,B]
        tb = jnp.min(tt, axis=-1)
        better = tb < best_t
        return (jnp.where(better, tb, best_t),
                jnp.where(better, uc * ch * k + kb, best_flat), occ)

    # Carry init derived from the (varying) ray data so shard_map's
    # varying-axis check accepts the loop (see ops/intersect.py).
    zb = tmb * 0.0                                            # [NB, B]
    init = (zb + BIG, zb.astype(jnp.int32) - 1, zb > 1.0)
    n_steps = (jnp.max(n_valid) + ch - 1) // ch
    best_t, best_flat, occ = jax.lax.fori_loop(0, n_steps, step, init)
    if any_hit:
        return occ.astype(jnp.float32), occ.astype(jnp.int32)
    return best_t, best_flat


def prepare_blocks(grid: ClusterGrid, o, d, t_max_arr, t_min: float,
                   block: int, max_u: int, sort: bool):
    """Everything before phase B: detach, root-box cull, optional
    direction-bin sort, pad to whole blocks, phase A.  Returns (perm or
    None, ob f32[NB,B,3], db f32[NB,B,3], tmb f32[NB,B], u_idx, u_entry,
    n_valid)."""
    n = o.shape[0]
    b = block
    o_sg, d_sg = sg(o), sg(d)
    t_max_arr = _root_cull(grid, o_sg, d_sg, t_min,
                           jnp.asarray(t_max_arr, jnp.float32))
    perm = None
    if sort:
        # Direction-scattered streams (bounce and shadow rays): stable bin
        # sort so each block's bundle is cone-coherent; the caller
        # unscrambles outputs.
        perm = _octant_perm(d_sg, t_max_arr)
        o_sg, d_sg, t_max_arr = o_sg[perm], d_sg[perm], t_max_arr[perm]
    n_pad = _round_up(n, b)
    pad = n_pad - n
    nb = n_pad // b
    ob = jnp.concatenate([o_sg, jnp.full((pad, 3), 3e30, jnp.float32)]
                         ).reshape(nb, b, 3)
    db = jnp.concatenate([d_sg, jnp.tile(
        jnp.array([[1.0, 0.0, 0.0]], jnp.float32), (pad, 1))]
    ).reshape(nb, b, 3)
    tmb = jnp.concatenate([t_max_arr, jnp.zeros((pad,), jnp.float32)]
                          ).reshape(nb, b)
    u_idx, u_entry, n_valid = _select_candidates(grid, ob, db, tmb, t_min,
                                                 max_u)
    return perm, ob, db, tmb, u_idx, u_entry, n_valid


@partial(jax.jit, static_argnames=("any_hit", "block", "max_u",
                                   "t_min_static", "sort", "kernel", "lean",
                                   "interpret"))
def _impl(grid: ClusterGrid, geometry, o, d, t_max_arr, *,
          t_min_static: float, any_hit: bool, block: int, max_u: int,
          sort: bool, kernel: str, lean: bool, interpret: bool):
    n = o.shape[0]
    t_min = t_min_static
    k = grid.k
    perm, ob, db, tmb, u_idx, u_entry, n_valid = prepare_blocks(
        grid, o, d, t_max_arr, t_min, block, max_u, sort)
    nb, b = tmb.shape
    n_pad = nb * b
    soup = grid.soup if grid.soup is not None else pack_soup(grid, geometry)
    if kernel == "triton":
        from .pallas_trace import trace_blocks_triton
        best_t, best_flat = trace_blocks_triton(
            u_idx, n_valid, u_entry, ob, db, tmb, soup, t_min=t_min,
            any_hit=any_hit, interpret=interpret)
    else:
        best_t, best_flat = _phase_b_xla(u_idx, n_valid, ob, db, tmb, soup,
                                         t_min, any_hit)

    if any_hit:
        occ = (best_flat > 0).reshape(n_pad)[:n]
        if sort:
            occ = jnp.zeros((n,), bool).at[perm].set(occ)
        return occ

    # Winner decode via flat 1-D gathers: flat = slot * K + lane.
    found = best_flat >= 0
    flat = jnp.maximum(best_flat, 0)
    n_u = u_idx.shape[1]
    blk = jnp.arange(nb, dtype=jnp.int32)[:, None]
    cl_win = jnp.minimum(u_idx.reshape(-1)[blk * n_u + flat // k],
                         grid.num_clusters - 1)
    tri = jnp.where(found, grid.tri_id.reshape(-1)[cl_win * k + flat % k],
                    -1).reshape(n_pad)[:n]
    t_k = best_t.reshape(n_pad)[:n]
    if sort:
        tri = jnp.full((n,), -1, jnp.int32).at[perm].set(tri)
        t_k = jnp.full((n,), BIG, jnp.float32).at[perm].set(t_k)
    found_n = tri >= 0

    if lean:
        # The dense integrator re-derives attached (u, v, t) in
        # shade_surface from its per-triangle attribute row, so the
        # tracer's own re-intersection would be duplicate work.  t is the
        # detached phase-B distance.
        zero = jnp.zeros((n,), jnp.float32)
        return Hit(t=jnp.where(found_n, t_k, BIG), tri=tri, u=zero, v=zero)

    # Differentiable finish on the winning triangle: attached t/u/v.
    safe = jnp.maximum(tri, 0)
    idx = geometry.indices[safe]
    p = geometry.positions
    w0 = p[idx[:, 0]]
    e1w = p[idx[:, 1]] - w0
    e2w = p[idx[:, 2]] - w0
    pv = jnp.cross(d, e2w)
    det = jnp.sum(pv * e1w, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > 1e-9, 1.0 / det, 0.0)
    tv = o - w0
    uq = jnp.sum(tv * pv, axis=-1) * inv_det
    q = jnp.cross(tv, e1w)
    vq = jnp.sum(d * q, axis=-1) * inv_det
    tq = jnp.sum(e2w * q, axis=-1) * inv_det
    return Hit(t=jnp.where(found_n, tq, BIG), tri=tri,
               u=jnp.where(found_n, uq, 0.0),
               v=jnp.where(found_n, vq, 0.0))


def intersect_blocks(grid: ClusterGrid, geometry, o, d, t_min: float = 1e-4,
                     t_max=BIG, any_hit: bool = False, block: int = 512,
                     max_u: int = 48, sort: bool = False,
                     kernel: str = "xla", lean: bool = False,
                     interpret: bool = False):
    """Closest-hit (Hit) or any-hit (bool[N]) via the block-stream tracer.

    kernel: phase B implementation, "xla" (any backend) or "triton" (the
      Pallas kernel; compiles for NVIDIA GPUs only — elsewhere it raises
      unless `interpret=True`, which runs it in the Pallas interpreter).
    lean: return a detached Hit (phase-B t, u = v = 0) for callers that
      re-derive attached intersection data themselves.
    sort: stable-sort rays by direction bin before blocking (outputs come
      back in caller order) — for direction-scattered streams.
    """
    if kernel not in KERNELS:
        raise ValueError(f"unknown phase-B kernel {kernel!r}; "
                         f"expected one of {KERNELS}")
    if kernel == "triton" and not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            f"the Triton block tracer compiles for NVIDIA GPUs only; the "
            f"default backend is {jax.default_backend()!r} (use kernel='xla', "
            f"or interpret=True to run it in the Pallas interpreter)")
    n = o.shape[0]
    t_max_arr = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    return _impl(grid, geometry, o, d, t_max_arr,
                 t_min_static=float(t_min), any_hit=any_hit, block=block,
                 max_u=max_u, sort=sort, kernel=kernel, lean=lean,
                 interpret=interpret)
