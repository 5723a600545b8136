"""Camera projection / backprojection ops.

Rebuild of the reference's depth->cloud utilities (SURVEY.md §3 "Depth
backprojection": organized point cloud from depth + K). Pure jnp; shapes
are [H,W] image grids; fuses into the
preprocessing jit (SURVEY.md §2 L2).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def backproject(depth: jax.Array, fx, fy, cx, cy) -> jax.Array:
    """Depth image [H,W] (meters) -> organized cloud [H,W,3] in camera frame.

    Camera convention: +z forward, +x right, +y down (OpenCV).
    Invalid (<=0) depths produce z=0 points; mask separately.
    """
    H, W = depth.shape
    u = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    v = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    x = (u - cx) / fx * depth
    y = (v - cy) / fy * depth
    return jnp.stack([x, y, depth], axis=-1)


def project(points: jax.Array, fx, fy, cx, cy) -> tuple[jax.Array, jax.Array]:
    """Points [..,N,3] camera frame -> (pixel uv [..,N,2], depth z [..,N]).

    z<=0 points project to uv but must be masked by the caller via z.
    """
    z = points[..., 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    u = points[..., 0] / safe_z * fx + cx
    v = points[..., 1] / safe_z * fy + cy
    return jnp.stack([u, v], axis=-1), z


def grid_normals(cloud: jax.Array, valid: jax.Array) -> jax.Array:
    """Surface normals on an organized cloud via image-grid finite differences.

    Replacement for PCL NormalEstimation (SURVEY.md §3 "Normal
    estimation"): cross product of central differences along the image grid,
    oriented toward the camera (-z half-space). Cheap, fully fused, no
    KD-tree. cloud [H,W,3], valid [H,W] bool -> normals [H,W,3] (zero where
    invalid or degenerate).
    """
    def shift(a, dy, dx):
        return jnp.roll(a, shift=(dy, dx), axis=(0, 1))

    vx0, vx1 = shift(cloud, 0, 1), shift(cloud, 0, -1)
    vy0, vy1 = shift(cloud, 1, 0), shift(cloud, -1, 0)
    mx = shift(valid, 0, 1) & shift(valid, 0, -1)
    my = shift(valid, 1, 0) & shift(valid, -1, 0)
    dx = vx1 - vx0
    dy = vy1 - vy0
    n = jnp.cross(dx, dy)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    ok = (norm[..., 0] > 1e-9) & mx & my & valid
    n = n / jnp.maximum(norm, 1e-9)
    # Orient toward camera: normal . viewdir < 0 where viewdir = p (camera at origin)
    flip = jnp.sum(n * cloud, axis=-1, keepdims=True) > 0
    n = jnp.where(flip, -n, n)
    return jnp.where(ok[..., None], n, 0.0)
