"""Cluster grid: the block tracer's acceleration structure.

Per-ray BVH stack walks turn into divergent control flow and per-lane
gathers when written as masked array code (ops/traverse.py).  The cluster
layout instead follows the ray-STREAM design (see PAPERS.md "ray stream
tracing"; SURVEY.md section 5 long-context analog):

  * triangles are partitioned into C equal-capacity clusters (the spatially
    tight leaf ranges of the accel/bvh.py builder, padded to exactly K tris
    with degenerate triangles), stored DENSE as an f32[C, 9, K] soup;
  * phase A culls ray BLOCKS against the cluster AABBs with a conservative
    interval slab test and keeps each block's nearest candidates;
  * phase B intersects each block's rays with its candidates' triangles —
    every read is a CONTIGUOUS cluster row (ops/blocktrace.py,
    ops/pallas_trace.py).

Scaling: work = sum over rays of (clusters pierced) x K, the same asymptotic
as a BVH with K-sized leaves, but in a form that is all dense vector math
with static shapes.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp
from ..core import struct

from .bvh import build_bvh

CLUSTER_K = 128  # triangles per cluster (padded)


@struct.dataclass
class ClusterGrid:
    aabb_min: jnp.ndarray  # f32[C, 3]
    aabb_max: jnp.ndarray  # f32[C, 3]
    tri_id: jnp.ndarray    # i32[C, K] original triangle ids (-1 = padding)
    # Pre-packed DETACHED triangle soup (built once on the host by
    # pack_soup_host) so trace calls do not re-gather it from the geometry.
    # Under vertex optimization it goes stale — grad/inverse refreshes it
    # via refit_clusters.
    soup: jnp.ndarray | None = None        # f32[C, 9, K]
    # PARENT boxes over groups of 4 CONSECUTIVE clusters (BVH order makes
    # consecutive clusters spatial neighbors).  Phase A selects parents
    # with a 4x smaller slab/top_k and expands children arithmetically
    # (ids 4p..4p+3) — the hierarchical candidate selection for grids with
    # many clusters, where a flat top_k over all of them dominates.
    parent_min: jnp.ndarray | None = None  # f32[ceil(C/4), 3]
    parent_max: jnp.ndarray | None = None  # f32[ceil(C/4), 3]

    @property
    def num_clusters(self) -> int:
        return self.aabb_min.shape[0]

    @property
    def k(self) -> int:
        return self.tri_id.shape[1]


def build_clusters(positions: np.ndarray, indices: np.ndarray,
                   k: int = CLUSTER_K) -> ClusterGrid:
    """Partition triangles into <=k-sized spatially tight clusters.

    Uses the BVH builder's leaf ranges (median splits over Morton order) so
    clusters are compact; pads each range to exactly k with id -1.
    """
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    bvh = build_bvh(positions, indices, leaf_size=k)
    left = np.asarray(bvh.node_left)
    right = np.asarray(bvh.node_right)
    nmin = np.asarray(bvh.node_min)
    nmax = np.asarray(bvh.node_max)
    order = np.asarray(bvh.tri_order)

    leaves = np.nonzero(left < 0)[0]
    c = len(leaves)
    tri_id = np.full((c, k), -1, np.int32)
    amin = np.empty((c, 3), np.float32)
    amax = np.empty((c, 3), np.float32)
    for i, nid in enumerate(leaves):
        start = -left[nid] - 1
        count = right[nid]
        tri_id[i, :count] = order[start:start + count]
        amin[i] = nmin[nid]
        amax[i] = nmax[nid]
    pmin, pmax = _parent_boxes(amin, amax)
    return ClusterGrid(aabb_min=amin, aabb_max=amax, tri_id=tri_id,
                       parent_min=pmin, parent_max=pmax)


def _parent_boxes(amin, amax, xp=np):
    """Union boxes over groups of 4 consecutive clusters; the tail group
    pads with inverted (never-hit) boxes."""
    c = amin.shape[0]
    npar = -(-c // 4)
    pad = npar * 4 - c
    big = xp.float32(3e30)
    lo = xp.concatenate(
        [amin, xp.full((pad, 3), big, xp.float32)], axis=0)
    hi = xp.concatenate(
        [amax, xp.full((pad, 3), -big, xp.float32)], axis=0)
    return (lo.reshape(npar, 4, 3).min(axis=1),
            hi.reshape(npar, 4, 3).max(axis=1))


def _soup_components(tri_id, positions, indices, xp):
    """(v0, e1, e2) component rows [C, 9, K] with degenerate padding; xp is
    numpy (ingest) or jnp (device refit)."""
    safe = xp.maximum(tri_id, 0)
    tri = indices[safe]                                  # [C,K,3]
    v0 = positions[tri[..., 0]]
    v1 = positions[tri[..., 1]]
    v2 = positions[tri[..., 2]]
    pad = (tri_id < 0)[..., None]
    v0 = xp.where(pad, xp.float32(2e30), v0)
    e1 = xp.where(pad, xp.float32(0.0), v1 - v0)
    e2 = xp.where(pad, xp.float32(0.0), v2 - v0)
    return xp.concatenate([xp.moveaxis(v0, -1, 1),
                           xp.moveaxis(e1, -1, 1),
                           xp.moveaxis(e2, -1, 1)], axis=1)  # [C,9,K]


def pack_soup_host(grid: ClusterGrid, positions: np.ndarray,
                   indices: np.ndarray) -> ClusterGrid:
    """Attach the packed per-cluster soup (numpy, ingest-time): f32[C, 9,
    K] rows (v0 xyz, e1 xyz, e2 xyz); padding slots carry far-away
    degenerate triangles (tri id -1)."""
    soup = _soup_components(np.asarray(grid.tri_id),
                            np.asarray(positions, np.float32),
                            np.asarray(indices, np.int32), np)
    return grid.replace(soup=soup)


def pack_soup(grid: ClusterGrid, geometry) -> jnp.ndarray:
    """Device version of the soup packing, from the CURRENT (detached)
    geometry: f32[C, 9, K]."""
    geometry = jax.tree.map(jax.lax.stop_gradient, geometry)
    return _soup_components(grid.tri_id, geometry.positions,
                            geometry.indices, jnp)


def refit_clusters(grid: ClusterGrid, geometry) -> ClusterGrid:
    """Device-side refit: recompute cluster AABBs + the packed soup from the
    CURRENT vertex positions (detached), keeping the triangle partition.

    The inverse-rendering loop calls this when `vertex_positions` is
    trainable (grad/inverse.py) so an optimized mesh never escapes its
    acceleration structure — the cluster analog of accel/bvh.refit_bvh.
    Cluster quality degrades gracefully if vertices move far (boxes grow,
    never miss).
    """
    soup = pack_soup(grid, geometry)                     # [C,9,K]
    v0 = soup[:, 0:3]
    v1 = v0 + soup[:, 3:6]
    v2 = v0 + soup[:, 6:9]
    pad = (grid.tri_id < 0)[:, None, :]
    big = jnp.float32(3e30)
    lo3 = jnp.minimum(jnp.minimum(v0, v1), v2)
    hi3 = jnp.maximum(jnp.maximum(v0, v1), v2)
    amin = jnp.where(pad, big, lo3).min(axis=2)          # [C,3]
    amax = jnp.where(pad, -big, hi3).max(axis=2)
    if grid.soup is None:
        soup = None  # keep the pytree structure stable for jit
    pmin = pmax = None
    if grid.parent_min is not None:
        pmin, pmax = _parent_boxes(amin, amax, xp=jnp)
    return grid.replace(aabb_min=amin, aabb_max=amax, soup=soup,
                        parent_min=pmin, parent_max=pmax)
