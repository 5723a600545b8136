"""Depth rendering.

Replacement for the reference's offscreen OpenGL FBO renderer
(SURVEY.md §3 "Offscreen depth renderer": rasterize object+hand mesh at a
hypothesis pose into a synthetic depth buffer, one GL call per particle
per PSO iteration). Two engines, both pure XLA:

1. `splat_depth` — the HOT path. Scatter-min z-buffering of a dense
   surface point sample with a small square splat footprint. vmaps over
   the particle axis, so all P hypothesis renders are ONE batched
   scatter instead of P serial GL dispatches (SURVEY.md §4.2). This is
   the pragmatic rasterizer SURVEY.md §8 hard part 3 calls for:
   occlusion-mask correctness matters, visual fidelity doesn't.

2. `raster_depth` — exact perspective-correct triangle rasterization as
   a lax.scan over faces with full-image edge tests. Too slow for the
   inner loop; used to generate synthetic ground-truth frames for the
   test/benchmark dataset (no released dataset in this environment) and
   for high-fidelity verification renders.

Convention: +z forward; depth in meters; empty pixels = +inf (callers
mask with isfinite).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

_PREC = jax.lax.Precision.HIGHEST


def splat_depth(
    points_cam: jax.Array,   # [N,3] camera-frame surface samples
    weights: jax.Array,      # [N] 0 disables a point (padding)
    *,
    fx: float, fy: float, cx: float, cy: float,
    height: int, width: int,
    radius: int = 1,
) -> jax.Array:
    """Point-splat depth image [H,W]; +inf where nothing rendered.

    Each point covers a (2r+1)^2 pixel footprint with min-depth. Realized
    as ONE radius-0 scatter into an r-padded grid followed by a (2r+1)^2
    min-pool (grayscale erosion) — bitwise-identical to scattering every
    footprint pixel (min commutes), but with 1 scatter instead of
    (2r+1)^2: one scatter pass, and pooling lowers to a cheap
    reduce_window. Batches cleanly under vmap.
    """
    z = points_cam[:, 2]
    valid = (z > 1e-6) & (weights > 0)
    safe_z = jnp.where(valid, z, 1.0)
    u = points_cam[:, 0] / safe_z * fx + cx
    v = points_cam[:, 1] / safe_z * fy + cy
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    r = radius
    hp, wp = height + 2 * r, width + 2 * r
    # centers within r of the image still contribute to in-bounds pixels
    inb = valid & (ui >= -r) & (ui < width + r) & (vi >= -r) & (vi < height + r)
    flat = jnp.where(inb, (vi + r) * wp + (ui + r), hp * wp)
    zval = jnp.where(valid, z, jnp.inf)
    zbuf = jnp.full((hp * wp + 1,), jnp.inf, dtype=points_cam.dtype)
    zbuf = zbuf.at[flat].min(zval, mode="drop")
    img = zbuf[: hp * wp].reshape(hp, wp)
    if r > 0:
        # separable min-pool: min over a (2r+1)^2 window == min over rows
        # then cols (bitwise-identical); 2(2r+1) loads/pixel instead of
        # (2r+1)^2 — the VGA hand-splat pool was ~2x the whole splat cost
        img = jax.lax.reduce_window(
            img, jnp.inf, jax.lax.min,
            window_dimensions=(2 * r + 1, 1),
            window_strides=(1, 1), padding="VALID",
        )
        img = jax.lax.reduce_window(
            img, jnp.inf, jax.lax.min,
            window_dimensions=(1, 2 * r + 1),
            window_strides=(1, 1), padding="VALID",
        )
    return img


def splat_depth_batched(
    points_cam: jax.Array,  # [P,N,3]
    weights: jax.Array,     # [N] or [P,N]
    **kwargs,
) -> jax.Array:
    """[P] particle renders as one batched scatter program."""
    if weights.ndim == 1:
        weights = jnp.broadcast_to(weights, points_cam.shape[:2])
    return jax.vmap(partial(splat_depth, **kwargs))(points_cam, weights)


@partial(jax.jit, static_argnames=("fx", "fy", "cx", "cy", "height", "width"))
def raster_depth(
    vertices_cam: jax.Array,  # [V,3] camera-frame vertices
    faces: jax.Array,         # [F,3] int32
    *,
    fx: float, fy: float, cx: float, cy: float,
    height: int, width: int,
) -> jax.Array:
    """Exact triangle rasterization -> depth [H,W], +inf empty.

    lax.scan over CHUNKS of faces; each step half-plane-tests a [C,H,W]
    block and folds it into the min z-buffer. Cost is O(F*H*W) —
    generator-grade, not inner-loop grade — but chunking keeps the scan
    short (a per-face scan is dispatch-bound at VGA).
    """
    z = vertices_cam[:, 2]
    safe_z = jnp.maximum(z, 1e-6)
    u = vertices_cam[:, 0] / safe_z * fx + cx
    v = vertices_cam[:, 1] / safe_z * fy + cy
    inv_z = 1.0 / safe_z
    front = z > 1e-6

    px = jax.lax.broadcasted_iota(jnp.float32, (height, width), 1) + 0.0
    py = jax.lax.broadcasted_iota(jnp.float32, (height, width), 0) + 0.0

    tri_u = u[faces]        # [F,3]
    tri_v = v[faces]
    tri_iz = inv_z[faces]
    tri_ok = front[faces].all(axis=-1)

    # pad face count to a chunk multiple with degenerate (culled) faces
    F = tri_u.shape[0]
    chunk = min(64, F) if F > 0 else 1
    Fp = ((F + chunk - 1) // chunk) * chunk
    pad = Fp - F
    tri_u = jnp.pad(tri_u, ((0, pad), (0, 0)))
    tri_v = jnp.pad(tri_v, ((0, pad), (0, 0)))
    tri_iz = jnp.pad(tri_iz, ((0, pad), (0, 0)))
    tri_ok = jnp.pad(tri_ok, ((0, pad),))
    to_chunks = lambda a: a.reshape(Fp // chunk, chunk, *a.shape[1:])

    def body(zbuf, tri):
        tu, tv, tiz, ok = tri                          # [C,3], [C]
        tu = tu[:, :, None, None]                      # [C,3,1,1]
        tv = tv[:, :, None, None]
        tiz = tiz[:, :, None, None]
        # edge functions: twice signed area terms, batched over the chunk
        d = (tv[:, 1] - tv[:, 2]) * (tu[:, 0] - tu[:, 2]) + \
            (tu[:, 2] - tu[:, 1]) * (tv[:, 0] - tv[:, 2])   # [C,1,1]
        d = jnp.where(jnp.abs(d) < 1e-12, 1e-12, d)
        l0 = ((tv[:, 1] - tv[:, 2]) * (px - tu[:, 2])
              + (tu[:, 2] - tu[:, 1]) * (py - tv[:, 2])) / d  # [C,H,W]
        l1 = ((tv[:, 2] - tv[:, 0]) * (px - tu[:, 2])
              + (tu[:, 0] - tu[:, 2]) * (py - tv[:, 2])) / d
        l2 = 1.0 - l0 - l1
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & ok[:, None, None]
        iz = l0 * tiz[:, 0] + l1 * tiz[:, 1] + l2 * tiz[:, 2]
        zpix = jnp.where(
            inside & (iz > 1e-9), 1.0 / jnp.maximum(iz, 1e-9), jnp.inf
        )
        return jnp.minimum(zbuf, jnp.min(zpix, axis=0)), None

    zbuf0 = jnp.full((height, width), jnp.inf, dtype=vertices_cam.dtype)
    zbuf, _ = jax.lax.scan(
        body, zbuf0,
        (to_chunks(tri_u), to_chunks(tri_v), to_chunks(tri_iz), to_chunks(tri_ok)),
    )
    return zbuf
