"""Visibility (boundary) gradients via silhouette edge sampling.

The detached-sampling integrator (integrator/path.py) differentiates only
the INTERIOR of the rendering equation: radiance is smooth in materials /
texels / shading geometry, so autodiff covers them — but a silhouette
moving across a pixel changes which surface the pixel sees, a step
discontinuity whose derivative lives on the EDGE, not in any interior
sample.  Pure translation of a flat-colored occluder therefore produced
exactly zero gradient (the failure mode tests/test_inverse.py documented).

This module adds the missing boundary term for PRIMARY visibility by
explicit edge sampling (after Li et al. 2018, "Differentiable Monte Carlo
ray tracing through edge sampling", simplified to the pinhole/box-filter
case):

  dI_j/dtheta = sum_silhouette_edges  integral over the edge of
                phi_j(s) * (L_minus(s) - L_plus(s)) * d(s . n_hat)/dtheta ds

where s(theta) is the screen-space edge point (ATTACHED to vertex
positions through the camera projection), n_hat its screen normal, and
L_plus/minus the (detached) radiance just either side.  Monte Carlo over
edge points; radiance differences come from two offset radiance probes per
sample, so edges hidden behind other geometry self-cancel (both probes see
the occluder).

The estimator is packaged as a ZERO-VALUED loss term whose gradient adds
the boundary contribution: loss_edge = T - stop_gradient(T) with
T = sum_k w_k(detached) * (s_k . n_k)(attached).  make_train_step wires it
in when vertex positions are trainable and an EdgeTable is supplied.

Scope (documented limitation): primary (camera) visibility only — the
dominant term for geometry recovery; secondary-bounce silhouettes remain
interior-only.  MEASURED bias (tests/test_edge_grad.py
test_secondary_visibility_gap_quantified): on a scene where only a SHADOW
boundary moves through the view (blocker silhouette outside the frustum),
finite differences give dL/dtheta = -0.028 while this estimator returns
exactly 0 — indirect/shadow silhouettes are 100% uncovered, by
construction.  Handling them needs boundary sampling at secondary vertices
(Li et al. 2018 section 4) — edge sampling with the path prefix as the
"camera", which multiplies the probe cost per bounce and is left as the
documented next step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from ..core import struct

from ..core.camera import Camera
from ..core import math3d

sg = jax.lax.stop_gradient


@struct.dataclass
class EdgeTable:
    """Mesh edge adjacency (host-built, static shapes)."""

    verts: jnp.ndarray   # i32[E, 2] vertex ids (a < b)
    faces: jnp.ndarray   # i32[E, 2] adjacent triangle ids (-1 = boundary)

    @property
    def num_edges(self) -> int:
        return self.verts.shape[0]


def build_edge_table(indices) -> EdgeTable:
    """Unique mesh edges + their (up to 2) adjacent triangles (numpy)."""
    indices = np.asarray(indices, np.int64)
    t = indices.shape[0]
    ea = indices[:, [0, 1, 2]].reshape(-1)
    eb = indices[:, [1, 2, 0]].reshape(-1)
    lo = np.minimum(ea, eb)
    hi = np.maximum(ea, eb)
    key = lo * (indices.max() + 1) + hi
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    tri_s = np.repeat(np.arange(t), 3)[order]
    uniq, start = np.unique(key_s, return_index=True)
    e = len(uniq)
    verts = np.stack([lo[order][start], hi[order][start]], axis=1)
    faces = np.full((e, 2), -1, np.int64)
    faces[:, 0] = tri_s[start]
    # second adjacent face (manifold edges have exactly two)
    second = np.minimum(start + 1, len(key_s) - 1)
    has2 = (start + 1 < len(key_s)) & (key_s[second] == uniq)
    faces[has2, 1] = tri_s[second[has2]]
    return EdgeTable(verts=jnp.asarray(verts, jnp.int32),
                     faces=jnp.asarray(faces, jnp.int32))


def _project(camera: Camera, x, width: int, height: int):
    """World point -> continuous pixel coords (attached); also returns the
    forward depth for behind-camera rejection.  Inverse of
    core.camera.generate_rays_at's NDC mapping."""
    right, up, fwd = camera.basis()
    v = x - camera.position
    # Elementwise dot products: an einsum is a contraction that a GPU may
    # run in TF32, too coarse for sub-pixel edge positions.
    a_f = jnp.sum(v * fwd, axis=-1)
    a_r = jnp.sum(v * right, axis=-1)
    a_u = jnp.sum(v * up, axis=-1)
    aspect = width / height
    tan_half = jnp.tan(camera.fov_y / 2.0)
    safe_f = jnp.where(jnp.abs(a_f) > 1e-8, a_f, 1e-8)
    ndc_x = a_r / safe_f
    ndc_y = a_u / safe_f
    px = (ndc_x / (aspect * tan_half) + 1.0) * (width * 0.5)
    py = (ndc_y / tan_half + 1.0) * (height * 0.5)
    return px, py, a_f


def edge_boundary_loss(scene, camera: Camera, cfg, dLdI: jnp.ndarray,
                       key: jax.Array, edges: EdgeTable,
                       n_samples: int = 1024,
                       eps_px: float = 0.5) -> jnp.ndarray:
    """Zero-valued loss term carrying the primary-visibility boundary
    gradient into scene.geometry.positions.

    dLdI f32[H, W, 3]: gradient of the pixel loss w.r.t. the rendered
    (mean) HDR image, evaluated at the DETACHED image.
    """
    from ..integrator.path import trace_radiance
    from ..core import rng as rng_mod
    from ..core.camera import generate_rays_at

    g = scene.geometry
    p = g.positions                                   # ATTACHED
    h_img, w_img = cfg.height, cfg.width
    va = p[edges.verts[:, 0]]                         # [E,3]
    vb = p[edges.verts[:, 1]]

    # --- silhouette classification (detached) ---------------------------
    # jnp-coerce: host scenes carry numpy indices, and inside a jitted
    # step the edge/face ids below are tracers (numpy[tracer] raises).
    idx = jnp.asarray(g.indices)
    f0 = jnp.maximum(edges.faces[:, 0], 0)
    f1 = jnp.maximum(edges.faces[:, 1], 0)

    def face_front(f):
        tri = idx[f]
        a = sg(p[tri[:, 0]])
        n = jnp.cross(sg(p[tri[:, 1]]) - a, sg(p[tri[:, 2]]) - a)
        to_cam = camera.position - a
        return jnp.sum(n * to_cam, axis=-1) > 0.0

    front0 = face_front(f0)
    front1 = face_front(f1)
    boundary = edges.faces[:, 1] < 0
    silhouette = jnp.where(boundary, front0, front0 != front1)

    pax, pay, fa = _project(camera, sg(va), w_img, h_img)
    pbx, pby, fb = _project(camera, sg(vb), w_img, h_img)
    visible = (fa > camera.znear) & (fb > camera.znear)
    chord = jnp.sqrt((pbx - pax) ** 2 + (pby - pay) ** 2)
    weight = jnp.where(silhouette & visible, chord, 0.0)      # [E]

    total = jnp.sum(weight)
    pdf_e = weight / jnp.maximum(total, 1e-12)
    cdf = jnp.cumsum(pdf_e)

    # --- sample edge points --------------------------------------------
    k1, k2, k3 = jax.random.split(key, 3)
    u_e = jax.random.uniform(k1, (n_samples,))
    u_t = jax.random.uniform(k2, (n_samples,))
    # O(K log E) pick — a dense [K, E] compare matrix would be ~150M
    # elements for a 100k-tri mesh.
    e_idx = jnp.searchsorted(cdf, u_e, side="left").astype(jnp.int32)
    e_idx = jnp.clip(e_idx, 0, edges.num_edges - 1)

    a = va[e_idx]                                     # [K,3] attached
    b = vb[e_idx]
    t3 = u_t[:, None]
    x_e = (1.0 - t3) * a + t3 * b                     # attached 3D point
    sx, sy, sf = _project(camera, x_e, w_img, h_img)  # attached screen pt

    # screen tangent d s / d t' (detached): derivative of
    # proj((1-t)a + t b) by cheap central difference in parameter space.
    dt = 1e-3
    xp_, yp_, _ = _project(camera, sg((1 - (u_t + dt))[:, None] * a
                                      + (u_t + dt)[:, None] * b),
                           w_img, h_img)
    xm_, ym_, _ = _project(camera, sg((1 - (u_t - dt))[:, None] * a
                                      + (u_t - dt)[:, None] * b),
                           w_img, h_img)
    tx = (xp_ - xm_) / (2 * dt)
    ty = (yp_ - ym_) / (2 * dt)
    ds_dt = jnp.sqrt(tx * tx + ty * ty)               # [K] px per unit t'
    inv_len = 1.0 / jnp.maximum(ds_dt, 1e-12)
    nx = -ty * inv_len                                # screen normal (unit)
    ny = tx * inv_len

    # --- radiance probes either side (detached) -------------------------
    px_p = sg(sx) + eps_px * sg(nx)
    py_p = sg(sy) + eps_px * sg(ny)
    px_m = sg(sx) - eps_px * sg(nx)
    py_m = sg(sy) - eps_px * sg(ny)
    zeros2 = jnp.zeros((n_samples, 2), jnp.float32)
    o_p, d_p = generate_rays_at(camera, w_img, h_img, px_p, py_p, zeros2)
    o_m, d_m = generate_rays_at(camera, w_img, h_img, px_m, py_m, zeros2)
    probe_keys = rng_mod.ray_keys(k3, jnp.arange(2 * n_samples))
    det_scene = jax.tree.map(sg, scene)
    L = trace_radiance(det_scene,
                       jnp.concatenate([o_p, o_m]),
                       jnp.concatenate([d_p, d_m]),
                       probe_keys, cfg)
    L = sg(L)
    L_plus = L[:n_samples]
    L_minus = L[n_samples:]

    # --- assemble the gradient-carrying term ----------------------------
    ix = jnp.clip(sg(sx).astype(jnp.int32), 0, w_img - 1)
    iy = jnp.clip(sg(sy).astype(jnp.int32), 0, h_img - 1)
    dl = dLdI[iy, ix]                                 # [K,3] detached
    dL_rgb = jnp.sum(dl * (L_minus - L_plus), axis=-1)  # [K]
    # MC weight: picked edge e with pdf_e, t' uniform; measure conversion
    # |ds/dt'| / (chord-based pdf).  In-pixel box filter value is 1 in
    # pixel units (image = per-pixel mean).
    pick_chord = jnp.maximum(chord[e_idx], 1e-12)
    w_mc = dL_rgb * ds_dt * total / (pick_chord * n_samples)
    # Off-screen samples contribute ZERO (their box-filter value is zero
    # for every pixel) — clamping them to border pixels would push
    # vertices based on loss values the edge point does not cover.
    on_screen = ((sg(sx) >= 0.0) & (sg(sx) < w_img)
                 & (sg(sy) >= 0.0) & (sg(sy) < h_img))
    valid = ((weight[e_idx] > 0.0) & (sg(sf) > camera.znear)
             & on_screen)
    w_mc = jnp.where(valid, w_mc, 0.0)

    s_n = sx * sg(nx) + sy * sg(ny)                   # attached normal coord
    term = jnp.sum(sg(w_mc) * s_n)
    return term - sg(term)
