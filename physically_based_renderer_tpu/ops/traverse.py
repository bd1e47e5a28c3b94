"""BVH traversal (XLA formulation): vectorized stack walk over ray batches.

All rays advance in lockstep through a `lax.while_loop`; each ray owns a
fixed-depth stack row.  One iteration pops one node per ray: leaves run a
statically-unrolled Moller-Trumbore over their (<= LEAF_SIZE, contiguous)
triangle range; internal nodes slab-test both child AABBs and push them
near-first.  No data-dependent shapes anywhere — the wavefront-friendly
formulation the north star prescribes (BASELINE.json; SURVEY.md section 7
"fixed-capacity queues + masks").

Triangle vertices are gathered from `geometry` through `bvh.tri_order` at
trace time so hits stay differentiable w.r.t. vertex positions (see
accel/bvh.py).  This module is the correctness baseline; the cluster
tracer (ops/blocktrace.py) is the fast path for large scenes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..accel.bvh import BVH, LEAF_SIZE, MAX_DEPTH
from .intersect import BIG, Hit


def _inv_dir(d: jnp.ndarray) -> jnp.ndarray:
    """Safe reciprocal direction for slab tests."""
    eps = 1e-12
    sign = jnp.where(d >= 0.0, 1.0, -1.0)
    return sign / jnp.maximum(jnp.abs(d), eps)


def _slab(node_min, node_max, o, inv_d, t_min, t_max):
    """Ray-AABB slab test -> (hit bool, t_entry). All [N, 3] inputs."""
    t0 = (node_min - o) * inv_d
    t1 = (node_max - o) * inv_d
    tn = jnp.minimum(t0, t1).max(axis=-1)
    tf = jnp.maximum(t0, t1).min(axis=-1)
    hit = (tn <= tf) & (tf >= t_min) & (tn <= t_max)
    return hit, jnp.maximum(tn, t_min)


def _mt(o, d, v0, e1, e2, t_min, t_max, eps=1e-9):
    """Moller-Trumbore, one triangle per ray ([N,3] each)."""
    p = jnp.cross(d, e2)
    det = jnp.sum(p * e1, axis=-1)
    inv_det = jnp.where(jnp.abs(det) > eps, 1.0 / det, 0.0)
    tv = o - v0
    u = jnp.sum(tv * p, axis=-1) * inv_det
    q = jnp.cross(tv, e1)
    v = jnp.sum(d * q, axis=-1) * inv_det
    t = jnp.sum(e2 * q, axis=-1) * inv_det
    ok = ((jnp.abs(det) > eps) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t > t_min) & (t < t_max))
    return t, u, v, ok


def intersect_bvh(bvh: BVH, geometry, o: jnp.ndarray, d: jnp.ndarray,
                  t_min: float = 1e-4,
                  t_max: float | jnp.ndarray = BIG,
                  any_hit: bool = False):
    """Closest-hit (or any-hit) of rays [N,3] against the BVH.

    Returns Hit (tri = ORIGINAL triangle ids) or, with any_hit=True, a
    bool[N] occlusion mask.
    """
    n = o.shape[0]
    rows = jnp.arange(n)
    # The tree SEARCH runs fully DETACHED (reverse-mode can't cross
    # lax.while_loop); the winning triangle is re-intersected differentiably
    # after the loop, which gives the exact same derivative away from
    # visibility discontinuities (the discrete winner is locally constant).
    o_s, d_s = jax.lax.stop_gradient((o, d))
    inv_d = _inv_dir(d_s)
    t_max_arr = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    # Gather triangle soup in BVH order.
    tri = geometry.indices[bvh.tri_order]          # [T,3]
    p = jax.lax.stop_gradient(geometry.positions)
    tv0 = p[tri[:, 0]]
    te1 = p[tri[:, 1]] - tv0
    te2 = p[tri[:, 2]] - tv0

    # Carry init derived from the (varying) ray directions so shard_map's
    # varying-axis check accepts the while_loop (see ops/intersect.py).
    zero = d_s[:, 0] * 0.0                          # [N] varying zeros
    izero = zero.astype(jnp.int32)
    stack = jnp.zeros((n, MAX_DEPTH), jnp.int32) + izero[:, None]
    sp = izero + 1  # root pre-pushed at slot 0

    state = dict(
        stack=stack, sp=sp,
        best_t=t_max_arr + zero, best_i=izero - 1,
        best_u=zero,
        best_v=zero,
    )

    def cond(s):
        if any_hit:
            return jnp.any((s["sp"] > 0) & (s["best_i"] < 0))
        return jnp.any(s["sp"] > 0)

    def body(s):
        sp = s["sp"]
        running = sp > 0
        if any_hit:
            running = running & (s["best_i"] < 0)
        sp_idx = jnp.maximum(sp - 1, 0)
        node = s["stack"][rows, sp_idx]
        sp = jnp.where(running, sp - 1, sp)

        left = bvh.node_left[node]
        right = bvh.node_right[node]
        is_leaf = left < 0
        start = -left - 1

        best_t, best_i = s["best_t"], s["best_i"]
        best_u, best_v = s["best_u"], s["best_v"]

        # ---- leaf: unrolled triangle tests ----
        for k in range(LEAF_SIZE):
            tidx = jnp.clip(start + k, 0, tv0.shape[0] - 1)
            lane = running & is_leaf & (k < right)
            t, u, v, ok = _mt(o_s, d_s, tv0[tidx], te1[tidx], te2[tidx],
                              t_min, best_t)
            win = lane & ok
            best_t = jnp.where(win, t, best_t)
            best_i = jnp.where(win, tidx, best_i)
            best_u = jnp.where(win, u, best_u)
            best_v = jnp.where(win, v, best_v)

        # ---- internal: child slab tests, push near-first ----
        inner = running & ~is_leaf
        l_idx = jnp.maximum(left, 0)
        r_idx = jnp.maximum(right, 0)
        hit_l, t_l = _slab(bvh.node_min[l_idx], bvh.node_max[l_idx], o_s,
                           inv_d, t_min, best_t)
        hit_r, t_r = _slab(bvh.node_min[r_idx], bvh.node_max[r_idx], o_s,
                           inv_d, t_min, best_t)
        l_first = t_l <= t_r
        first = jnp.where(l_first, l_idx, r_idx)
        second = jnp.where(l_first, r_idx, l_idx)
        hit_first = jnp.where(l_first, hit_l, hit_r)
        hit_second = jnp.where(l_first, hit_r, hit_l)

        stack = s["stack"]
        # push far child first so the near child pops first
        push2 = inner & hit_second
        slot = jnp.minimum(sp, MAX_DEPTH - 1)
        stack = stack.at[rows, slot].set(
            jnp.where(push2, second, stack[rows, slot]))
        sp = sp + push2.astype(jnp.int32)
        push1 = inner & hit_first
        slot = jnp.minimum(sp, MAX_DEPTH - 1)
        stack = stack.at[rows, slot].set(
            jnp.where(push1, first, stack[rows, slot]))
        sp = sp + push1.astype(jnp.int32)

        return dict(stack=stack, sp=sp, best_t=best_t, best_i=best_i,
                    best_u=best_u, best_v=best_v)

    out = jax.lax.while_loop(cond, body, state)
    found = out["best_i"] >= 0
    if any_hit:
        return found
    # Differentiable re-intersection of the (detached) winning triangle.
    win = jnp.maximum(out["best_i"], 0)
    widx = tri[win]                                 # [N,3] original verts
    pa = geometry.positions
    w0 = pa[widx[:, 0]]
    t, u, v, _ = _mt(o, d, w0, pa[widx[:, 1]] - w0, pa[widx[:, 2]] - w0,
                     t_min, BIG)
    orig_tri = jnp.where(found, bvh.tri_order[win], -1)
    return Hit(t=jnp.where(found, t, BIG),
               tri=orig_tri,
               u=jnp.where(found, u, 0.0),
               v=jnp.where(found, v, 0.0))
