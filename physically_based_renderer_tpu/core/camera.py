"""Camera model and primary-ray generation.

Mirrors the reference camera semantics (`src/pbr_engine/engine/pbr/
CameraData.hpp:22-32`): right-handed lookAt with **y-down** up vector
(0,-1,0), vertical-FOV perspective, znear 0.01 / zfar 1024.  The reference
stores {view, proj, position} in a UBO (`CameraData.hpp:14-18`); here the
same triple is a pytree dataclass, and the "vertex transform" becomes
primary-ray generation for the path tracer.

Pixel convention: pixel (0,0) is the TOP-LEFT of the image, x right, y down
(matches Vulkan viewport / the reference's framebuffer orientation), so a
rendered array[y, x] compares directly against reference images.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from . import struct

from . import math3d

ZNEAR = 0.01   # CameraData.hpp:24
ZFAR = 1024.0  # CameraData.hpp:25
UP_Y_DOWN = (0.0, -1.0, 0.0)  # CameraData.hpp:28


@struct.dataclass
class Camera:
    """Pinhole camera. All fields are jnp scalars/vectors => differentiable."""

    position: jnp.ndarray  # f32[3]
    target: jnp.ndarray    # f32[3]
    up: jnp.ndarray        # f32[3]
    fov_y: jnp.ndarray     # f32[] vertical field of view, radians
    znear: jnp.ndarray     # f32[]
    zfar: jnp.ndarray      # f32[]

    @classmethod
    def make(cls, position, target, fov_y=1.0471976, up=UP_Y_DOWN,
             znear=ZNEAR, zfar=ZFAR) -> "Camera":
        f32 = lambda v: jnp.asarray(v, jnp.float32)
        return cls(position=f32(position), target=f32(target), up=f32(up),
                   fov_y=f32(fov_y), znear=f32(znear), zfar=f32(zfar))

    def view_matrix(self) -> jnp.ndarray:
        return math3d.look_at_rh(self.position, self.target, self.up)

    def proj_matrix(self, aspect: float) -> jnp.ndarray:
        return math3d.perspective_rh_no(self.fov_y, aspect, self.znear, self.zfar)

    def basis(self):
        """Camera-space basis in world coords: (right, up, forward)."""
        fwd = math3d.normalize(self.target - self.position)
        right = math3d.normalize(jnp.cross(fwd, self.up))
        up = jnp.cross(right, fwd)
        return right, up, fwd


def generate_rays(camera: Camera, width: int, height: int,
                  jitter: jnp.ndarray | None = None,
                  row_start=0, n_rows: int | None = None):
    """Primary rays for a row block of a width x height image.

    jitter: optional f32[n_rows, width, 2] in [0,1) for sub-pixel AA
    sampling; None = pixel centers (0.5, 0.5).
    row_start / n_rows select a horizontal band (for tile sharding —
    parallel/); defaults cover the full image.

    Returns (origins f32[n_rows,W,3], directions f32[n_rows,W,3] unit).

    Convention: NDC x in [-1,1] right, y in [-1,1]; with the reference's
    y-down up-vector (CameraData.hpp:28) the camera 'up' basis points down in
    world space, which cancels Vulkan's y-down framebuffer — world +y renders
    to the TOP image rows, matching the reference's presented orientation.
    """
    if n_rows is None:
        n_rows = height
    aspect = width / height
    right, up, fwd = camera.basis()
    tan_half = jnp.tan(camera.fov_y / 2.0)

    xs = jnp.arange(width, dtype=jnp.float32)
    ys = jnp.arange(n_rows, dtype=jnp.float32) + jnp.asarray(
        row_start, jnp.float32)
    px, py = jnp.meshgrid(xs, ys)  # [n_rows, W]
    if jitter is None:
        off = jnp.full((n_rows, width, 2), 0.5, jnp.float32)
    else:
        off = jitter
    # NDC in [-1, 1]
    ndc_x = (2.0 * (px + off[..., 0]) / width - 1.0) * aspect * tan_half
    ndc_y = (2.0 * (py + off[..., 1]) / height - 1.0) * tan_half
    d = (ndc_x[..., None] * right + ndc_y[..., None] * up + fwd)
    d = math3d.normalize(d)
    o = jnp.broadcast_to(camera.position, d.shape)
    return o, d


def generate_rays_at(camera: Camera, width: int, height: int,
                     px: jnp.ndarray, py: jnp.ndarray,
                     jitter: jnp.ndarray):
    """Primary rays at explicit pixel coordinates (flat batch form).

    px, py: f32[N] integer pixel coords; jitter: f32[N, 2] in [0,1).
    Same NDC/basis conventions as generate_rays — generate_rays(...) equals
    generate_rays_at on the row-major meshgrid.  Used by the morton-ordered
    trace path (core/morton.py), where ray order != image order.

    Returns (origins f32[N,3], directions f32[N,3] unit).
    """
    aspect = width / height
    right, up, fwd = camera.basis()
    tan_half = jnp.tan(camera.fov_y / 2.0)
    ndc_x = (2.0 * (px + jitter[:, 0]) / width - 1.0) * aspect * tan_half
    ndc_y = (2.0 * (py + jitter[:, 1]) / height - 1.0) * tan_half
    d = ndc_x[:, None] * right + ndc_y[:, None] * up + fwd
    d = math3d.normalize(d)
    o = jnp.broadcast_to(camera.position, d.shape)
    return o, d


def generate_rays_flat(camera: Camera, width: int, height: int,
                       key: jax.Array | None = None):
    """Flat [H*W, 3] ray batch with optional (legacy, non-shard-invariant)
    jitter from a single `key`.  Integrators use per-ray keys instead."""
    jitter = None
    if key is not None:
        jitter = jax.random.uniform(key, (height, width, 2), jnp.float32)
    o, d = generate_rays(camera, width, height, jitter)
    return o.reshape(-1, 3), d.reshape(-1, 3)
