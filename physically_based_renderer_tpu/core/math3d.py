"""Small 3D math library: vectors, quaternions, TRS transforms, camera matrices.

Replacement for the reference engine's use of glm (see SURVEY.md
section 2.11; reference: `src/pbr_engine/engine/pbr/CameraData.hpp:22-32`,
`ModelPushConstant.hpp:40-46`).  Everything is pure jnp, batched-friendly
(all ops broadcast over leading dims), f32 by default, and differentiable.

Conventions (match the reference so renders can be compared):
  * Right-handed world space.
  * Camera: `look_at_rh` with the reference's Y-DOWN up vector (0,-1,0)
    (`CameraData.hpp:28`), znear 0.01 / zfar 1024 defaults
    (`CameraData.hpp:24-25`).
  * Quaternions are (x, y, z, w), glTF order.
"""

from __future__ import annotations

import jax.numpy as jnp

EPS = 1e-8


# ---------------------------------------------------------------------------
# Vectors
# ---------------------------------------------------------------------------

def dot(a: jnp.ndarray, b: jnp.ndarray, keepdims: bool = True) -> jnp.ndarray:
    """Batched dot product over the last axis."""
    return jnp.sum(a * b, axis=-1, keepdims=keepdims)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def length(v: jnp.ndarray, keepdims: bool = True) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(jnp.sum(v * v, axis=-1, keepdims=keepdims), EPS * EPS))


def normalize(v: jnp.ndarray) -> jnp.ndarray:
    """Safe normalize over the last axis (returns v/|v|, guarded near 0)."""
    return v / length(v)


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Reflect direction `d` about normal `n` (both unit)."""
    return d - 2.0 * dot(d, n) * n


def luminance(rgb: jnp.ndarray) -> jnp.ndarray:
    """Rec.709 luminance of linear RGB, over the last axis."""
    w = jnp.array([0.2126, 0.7152, 0.0722], dtype=rgb.dtype)
    return jnp.sum(rgb * w, axis=-1)


def orthonormal_basis(n: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Build tangent/bitangent for unit normal `n` (branchless Duff et al.).

    Returns (t, b) with [t, b, n] a right-handed orthonormal frame.
    """
    s = jnp.where(n[..., 2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2:3])
    bv = n[..., 0:1] * n[..., 1:2] * a
    t = jnp.concatenate(
        [1.0 + s * n[..., 0:1] ** 2 * a, s * bv, -s * n[..., 0:1]], axis=-1
    )
    b = jnp.concatenate([bv, s + n[..., 1:2] ** 2 * a, -n[..., 1:2]], axis=-1)
    return t, b


def to_world(local: jnp.ndarray, t: jnp.ndarray, b: jnp.ndarray,
             n: jnp.ndarray) -> jnp.ndarray:
    """Transform a local-frame (tangent space) vector into world space."""
    return (local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n)


def to_local(world: jnp.ndarray, t: jnp.ndarray, b: jnp.ndarray,
             n: jnp.ndarray) -> jnp.ndarray:
    """Transform a world vector into the [t,b,n] local frame."""
    return jnp.stack(
        [dot(world, t, False), dot(world, b, False), dot(world, n, False)], axis=-1
    )


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w) — glTF component order
# ---------------------------------------------------------------------------

def quat_identity() -> jnp.ndarray:
    return jnp.array([0.0, 0.0, 0.0, 1.0], dtype=jnp.float32)


def quat_mul(q1: jnp.ndarray, q2: jnp.ndarray) -> jnp.ndarray:
    x1, y1, z1, w1 = jnp.moveaxis(q1, -1, 0)
    x2, y2, z2, w2 = jnp.moveaxis(q2, -1, 0)
    return jnp.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        axis=-1,
    )


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vector(s) v by unit quaternion(s) q."""
    qv = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * jnp.cross(qv, v)
    return v + w * t + jnp.cross(qv, t)


def quat_from_axis_angle(axis: jnp.ndarray, angle) -> jnp.ndarray:
    """Unit quaternion rotating by `angle` (radians) about `axis`.

    Broadcasts: axis [..., 3], angle [...] -> quat [..., 4].
    """
    axis = normalize(jnp.asarray(axis, jnp.float32))
    half = jnp.asarray(angle, jnp.float32)[..., None] / 2.0
    return jnp.concatenate([axis * jnp.sin(half), jnp.cos(half)], axis=-1)


def quat_to_mat3(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion -> 3x3 rotation matrix (batched over leading dims)."""
    x, y, z, w = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def mat3_to_quat(m: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> quaternion (x,y,z,w). Branchless, f32."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidate constructions; pick the numerically best.
    qw = jnp.sqrt(jnp.maximum(0.0, 1.0 + tr)) / 2.0
    qx = jnp.sqrt(jnp.maximum(0.0, 1.0 + m00 - m11 - m22)) / 2.0
    qy = jnp.sqrt(jnp.maximum(0.0, 1.0 - m00 + m11 - m22)) / 2.0
    qz = jnp.sqrt(jnp.maximum(0.0, 1.0 - m00 - m11 + m22)) / 2.0
    qx = jnp.copysign(qx, m21 - m12)
    qy = jnp.copysign(qy, m02 - m20)
    qz = jnp.copysign(qz, m10 - m01)
    q = jnp.stack([qx, qy, qz, qw], axis=-1)
    return normalize(q)


# ---------------------------------------------------------------------------
# TRS transforms  (reference: Scene.hpp:19-23 Transform{position, rotation,
# scale}; ModelPushConstant.hpp:40-46 builds translate*rotate*scale)
# ---------------------------------------------------------------------------

def trs_to_mat4(translation: jnp.ndarray, rotation_quat: jnp.ndarray,
                scale: jnp.ndarray) -> jnp.ndarray:
    """Compose translate @ rotate @ scale into a 4x4 (matches reference order,
    `ModelPushConstant.hpp:41-44`)."""
    r = quat_to_mat3(rotation_quat) * jnp.asarray(scale)[..., None, :]
    m = jnp.zeros(r.shape[:-2] + (4, 4), dtype=r.dtype)
    m = m.at[..., :3, :3].set(r)
    m = m.at[..., :3, 3].set(translation)
    m = m.at[..., 3, 3].set(1.0)
    return m


def normal_matrix(model: jnp.ndarray) -> jnp.ndarray:
    """Inverse-transpose of the upper 3x3 (reference `ModelPushConstant.hpp:45`)."""
    return jnp.linalg.inv(model[..., :3, :3]).mT


def transform_points(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Apply 4x4 `m` to points p[..., 3]."""
    return p @ m[..., :3, :3].mT + m[..., :3, 3]


def transform_dirs(m: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Apply the linear part of 4x4 `m` to directions d[..., 3] (no translate)."""
    return d @ m[..., :3, :3].mT


# ---------------------------------------------------------------------------
# Camera matrices  (reference: CameraData.hpp:22-32)
# ---------------------------------------------------------------------------

def look_at_rh(eye: jnp.ndarray, center: jnp.ndarray,
               up: jnp.ndarray) -> jnp.ndarray:
    """Right-handed look-at view matrix, glm::lookAtRH semantics."""
    eye = jnp.asarray(eye, jnp.float32)
    center = jnp.asarray(center, jnp.float32)
    up = jnp.asarray(up, jnp.float32)
    f = normalize(center - eye)          # forward
    s = normalize(jnp.cross(f, up))      # right
    u = jnp.cross(s, f)                  # true up
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[0, :3].set(s).at[1, :3].set(u).at[2, :3].set(-f)
    m = m.at[0, 3].set(-jnp.dot(s, eye))
    m = m.at[1, 3].set(-jnp.dot(u, eye))
    m = m.at[2, 3].set(jnp.dot(f, eye))
    return m


def perspective_rh_no(fovy: float, aspect: float, znear: float,
                      zfar: float) -> jnp.ndarray:
    """glm::perspectiveRH_NO (depth -1..1), as called by the reference
    (`CameraData.hpp:30` — it calls the _NO variant explicitly)."""
    tan_half = jnp.tan(jnp.asarray(fovy, jnp.float32) / 2.0)
    m = jnp.zeros((4, 4), dtype=jnp.float32)
    m = m.at[0, 0].set(1.0 / (aspect * tan_half))
    m = m.at[1, 1].set(1.0 / tan_half)
    m = m.at[2, 2].set(-(zfar + znear) / (zfar - znear))
    m = m.at[2, 3].set(-(2.0 * zfar * znear) / (zfar - znear))
    m = m.at[3, 2].set(-1.0)
    return m


def perspective_rh_zo(fovy: float, aspect: float, znear: float,
                      zfar: float) -> jnp.ndarray:
    """glm::perspectiveRH_ZO (depth 0..1, Vulkan-style)."""
    tan_half = jnp.tan(jnp.asarray(fovy, jnp.float32) / 2.0)
    m = jnp.zeros((4, 4), dtype=jnp.float32)
    m = m.at[0, 0].set(1.0 / (aspect * tan_half))
    m = m.at[1, 1].set(1.0 / tan_half)
    m = m.at[2, 2].set(zfar / (znear - zfar))
    m = m.at[2, 3].set(-(zfar * znear) / (zfar - znear))
    m = m.at[3, 2].set(-1.0)
    return m
