"""BVH build (host) + SoA device layout.

The acceleration structure the north star requires for DamagedHelmet-class
meshes (BASELINE config #4).  The reference has no ray tracing at all (its
visibility is the raster depth test); this subsystem is new.

Build: binned-SAH-lite median/largest-axis splits over Morton-sorted
triangles, producing a binary BVH with multi-triangle leaves over a
REORDERED triangle array, so every leaf is a contiguous range — the layout
both the XLA and the Pallas traversers want (one gather per leaf, coherent).
The builder is numpy (ingest-time); accel/native.py swaps in the C++
implementation when built, same layout.

Device layout (pytree, replicated per chip like the rest of the scene):
  node_min/max  f32[N,3]   child AABBs
  node_left     i32[N]     >= 0: left child index; < 0: leaf, start = -x-1
  node_right    i32[N]     >= 0: right child index; for leaves: tri count
  tri_order     i32[T]     BVH triangle order -> ORIGINAL triangle id

Triangle vertices are NOT stored in the BVH: traversal gathers them from
scene geometry through tri_order at trace time, which keeps the whole
intersection differentiable w.r.t. vertex positions (and the BVH valid
under refit-free small deformations during inverse rendering).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from ..core import struct

LEAF_SIZE = 4
MAX_DEPTH = 64


@struct.dataclass
class BVH:
    node_min: jnp.ndarray    # f32[N,3]
    node_max: jnp.ndarray    # f32[N,3]
    node_left: jnp.ndarray   # i32[N]
    node_right: jnp.ndarray  # i32[N]
    tri_order: jnp.ndarray   # i32[T] bvh position -> original tri id

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]

    @property
    def num_tris(self) -> int:
        return self.tri_order.shape[0]


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit coords -> 30-bit Morton codes. x: u32[N,3] in
    [0,1024)."""
    def split(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v
    return (split(x[:, 0]) << np.uint64(2)) | (split(x[:, 1])
                                               << np.uint64(1)) | split(
                                                   x[:, 2])


def build_bvh(positions: np.ndarray, indices: np.ndarray,
              leaf_size: int = LEAF_SIZE) -> BVH:
    """Host BVH build. positions f32[V,3], indices i32[T,3]."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    t = indices.shape[0]
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    centroid = (v0 + v1 + v2) / 3.0
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)

    # Morton pre-sort for locality (makes median splits near-LBVH quality).
    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    q = ((centroid - lo) / np.maximum(hi - lo, 1e-12) * 1023.0).astype(
        np.uint32)
    order = np.argsort(_morton3(q), kind="stable").astype(np.int32)

    # Iterative top-down build over index ranges of `order`.
    node_min, node_max, node_left, node_right = [], [], [], []

    def new_node():
        node_min.append(np.zeros(3, np.float32))
        node_max.append(np.zeros(3, np.float32))
        node_left.append(0)
        node_right.append(0)
        return len(node_left) - 1

    out_order = np.empty(t, np.int32)
    out_pos = 0
    root = new_node()
    # stack of (node_id, start, end) over `order`
    stack = [(root, 0, t)]
    while stack:
        nid, s, e = stack.pop()
        ids = order[s:e]
        bmin = tmin[ids].min(axis=0)
        bmax = tmax[ids].max(axis=0)
        node_min[nid] = bmin
        node_max[nid] = bmax
        count = e - s
        if count <= leaf_size:
            node_left[nid] = -(out_pos + 1)
            node_right[nid] = count
            out_order[out_pos:out_pos + count] = ids
            out_pos += count
            continue
        # split at median of the largest centroid axis; stable full sort so
        # the native (C++) builder can reproduce the order bit-exactly
        c = centroid[ids]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        m = count // 2
        part = np.argsort(c[:, axis], kind="stable")
        order[s:e] = ids[part]
        left = new_node()
        right = new_node()
        node_left[nid] = left
        node_right[nid] = right
        stack.append((right, s + m, e))
        stack.append((left, s, s + m))
    assert out_pos == t

    tri_order = out_order
    return BVH(
        node_min=np.stack(node_min).astype(np.float32),
        node_max=np.stack(node_max).astype(np.float32),
        node_left=np.asarray(node_left, np.int32),
        node_right=np.asarray(node_right, np.int32),
        tri_order=tri_order,
    )


def refit_bvh(bvh: BVH, positions, indices,
              pad: float = 0.0) -> BVH:
    """Host AABB refit after vertex moves (bottom-up over the node list;
    builder emits parents before children, so reverse order is bottom-up).
    Used by inverse rendering when optimizing vertex_positions; rebuild for
    large deformation."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    order = np.asarray(bvh.tri_order)
    v0 = positions[indices[order, 0]]
    v1 = positions[indices[order, 1]]
    v2 = positions[indices[order, 2]]
    tmin = np.minimum(np.minimum(v0, v1), v2) - pad
    tmax = np.maximum(np.maximum(v0, v1), v2) + pad
    left = np.asarray(bvh.node_left)
    right = np.asarray(bvh.node_right)
    nmin = np.array(bvh.node_min)
    nmax = np.array(bvh.node_max)
    for nid in range(len(left) - 1, -1, -1):
        if left[nid] < 0:
            s0 = -left[nid] - 1
            c = right[nid]
            nmin[nid] = tmin[s0:s0 + c].min(axis=0)
            nmax[nid] = tmax[s0:s0 + c].max(axis=0)
        else:
            nmin[nid] = np.minimum(nmin[left[nid]], nmin[right[nid]])
            nmax[nid] = np.maximum(nmax[left[nid]], nmax[right[nid]])
    return bvh.replace(node_min=nmin, node_max=nmax)


def bvh_depth(bvh: BVH) -> int:
    """Maximum depth (host check that MAX_DEPTH stacks suffice)."""
    left = np.asarray(bvh.node_left)
    right = np.asarray(bvh.node_right)
    depth = 0
    stack = [(0, 1)]
    while stack:
        nid, d = stack.pop()
        depth = max(depth, d)
        if left[nid] >= 0:
            stack.append((left[nid], d + 1))
            stack.append((right[nid], d + 1))
    return depth


def validate_bvh(bvh: BVH, positions, indices) -> None:
    """Structural invariants (debug): every tri exactly once; child boxes
    inside parents; leaf ranges disjoint+complete."""
    t = np.asarray(bvh.tri_order)
    assert np.array_equal(np.sort(t), np.arange(len(t)))
    left = np.asarray(bvh.node_left)
    right = np.asarray(bvh.node_right)
    nmin = np.asarray(bvh.node_min)
    nmax = np.asarray(bvh.node_max)
    stack = [0]
    seen = 0
    while stack:
        nid = stack.pop()
        if left[nid] < 0:
            seen += right[nid]
            continue
        for c in (left[nid], right[nid]):
            assert (nmin[c] >= nmin[nid] - 1e-5).all()
            assert (nmax[c] <= nmax[nid] + 1e-5).all()
            stack.append(c)
    assert seen == len(t)
