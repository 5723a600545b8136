"""Fused depth-frame preprocessing.

Rebuild of the reference's per-frame preprocessing chain
(SURVEY.md §4.2: Utils::depth2cloud + Utils::estimateNormals + validity
filtering, originally PCL calls on the host). Here the whole chain is ONE
XLA program over the [H,W] grid: backprojection, grid normals, validity
masks, and fixed-size subsampling to a static [Ns] scene cloud (static
shapes are mandatory under jit — SURVEY.md §8 hard part 1).

The ragged->static trick: valid points carry random priorities and a
lattice-stratified per-bucket argmin picks one per output slot (see
subsample_cloud); padding slots carry weight 0 so they contribute
nothing to ICP normal equations or scoring.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import camera


class SceneCloud(NamedTuple):
    """Fixed-size scene observation, all static shapes.

    points:  [Ns,3] camera-frame points (padding -> large sentinel coords)
    normals: [Ns,3] unit normals (padding -> 0)
    weights: [Ns]   1.0 valid / 0.0 padding
    depth:   [h,w]  render-factor-downsampled depth (0 = invalid) — the
             coarse scoring tier for the PSO basin search
    valid:   [h,w]  bool validity mask of `depth`
    depth_full: [H,W] full-resolution depth — the fine scoring tier
             (final polish acceptance + finisher)
    valid_full: [H,W]
    neutral / neutral_full: pixels the camera MEASURED in range but that
             were excluded from object evidence (hand segmentation drop,
             speckle removal). Scoring must treat them as no-evidence,
             not as free space: the reference's occlusion reasoning never
             penalizes a hypothesis for rendering onto a surface that was
             merely claimed by the hand (SURVEY.md §3 render-and-compare
             scorer). Measured failure without this class: a grasped
             object's samples on conservatively-dropped pixels paid the
             ghost penalty (34/206 visible samples at box init t=17),
             letting a 24 mm slide out-score truth at the fine tier.
    """
    points: jax.Array
    normals: jax.Array
    weights: jax.Array
    depth: jax.Array
    valid: jax.Array
    depth_full: jax.Array
    valid_full: jax.Array
    neutral: jax.Array
    neutral_full: jax.Array


def speckle_mask(
    depth: jax.Array, valid: jax.Array, *, tau: float, min_neighbors: int
) -> jax.Array:
    """Statistical outlier removal, grid-shaped (SURVEY.md §2 L2: the
    reference runs PCL outlier removal on the unorganized cloud; the
    rebuild exploits the image grid instead of a KD-tree).

    A valid pixel survives only if >= min_neighbors of its 8-neighborhood
    are valid AND within `tau` meters of it — isolated depth speckle
    ("flying pixels" at silhouette edges, shot noise) has no coherent
    neighborhood and is dropped; real surfaces (even one pixel from an
    edge) keep 3-5 coherent neighbors. Pure shifted elementwise compares:
    no sort, no scatter/gather, fuses into the preprocessing program.
    """
    # large FINITE sentinel: inf-inf would make NaNs that trip the
    # jax_debug_nans CI guard (tests/test_debug_guards.py)
    big = jnp.asarray(1e9, depth.dtype)
    d = jnp.where(valid, depth, big)
    dp = jnp.pad(d, 1, constant_values=1e9)
    H, W = depth.shape
    count = jnp.zeros(depth.shape, jnp.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = jax.lax.dynamic_slice(dp, (1 + dy, 1 + dx), (H, W))
            count = count + (jnp.abs(n - d) < tau).astype(jnp.int32)
    return valid & (count >= min_neighbors)


def downsample_depth(depth: jax.Array, valid: jax.Array, factor: int) -> tuple[jax.Array, jax.Array]:
    """Min-pool depth by `factor` (foreground-preserving), propagate validity."""
    if factor == 1:
        return depth, valid
    H, W = depth.shape
    Hc, Wc = H // factor, W // factor
    d = jnp.where(valid, depth, jnp.inf)
    d = d[: Hc * factor, : Wc * factor].reshape(Hc, factor, Wc, factor)
    dmin = jnp.min(jnp.min(d, axis=3), axis=1)
    v = jnp.isfinite(dmin)
    return jnp.where(v, dmin, 0.0), v


def downsample_mask_any(mask: jax.Array, factor: int) -> jax.Array:
    """Any-pool a bool mask by `factor` (a low-res cell inherits the class
    if any constituent pixel carries it)."""
    if factor == 1:
        return mask
    H, W = mask.shape
    Hc, Wc = H // factor, W // factor
    m = mask[: Hc * factor, : Wc * factor].reshape(Hc, factor, Wc, factor)
    return jnp.any(jnp.any(m, axis=3), axis=1)


def subsample_cloud(
    key: jax.Array,
    points: jax.Array,
    normals: jax.Array,
    valid: jax.Array,
    n_out: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Random fixed-size subsample of valid grid points.

    points/normals [H,W,3], valid [H,W] -> ([n,3], [n,3], weights [n]).

    2-D lattice-stratified bucket sampling — no sort, no top_k. The
    grid is bucketed by pixel residue (y mod gh, x mod gw) with
    gh*gw = n_out, so each bucket is a coarse lattice (spacing gh rows
    x gw cols) sweeping the whole frame — any object larger than one
    lattice cell lands valid pixels in essentially every bucket, and
    no axis-aligned validity structure can starve a bucket (a flat
    stride-n_out scheme aliases when n_out % W == 0: each bucket
    degenerates to a single image column). One random-priority argmin
    per bucket picks a uniform valid pixel from that bucket. Replaces
    lax.top_k over the 307k-entry VGA grid (a sorting network); reshape
    + argmin is one reduction pass. Cost: a bucket with no valid pixel yields a
    weight-0 slot even if other buckets are dense (only relevant for
    objects far smaller than one lattice cell); a fixed valid-sample
    count was never semantically required — weights carry validity.

    The output slots are randomly PERMUTED: raw bucket order is spatially
    structured (slot c = residue class (c//gw, c%gw), so a contiguous
    slot range covers only a stripe of row residues) and downstream
    consumers take prefixes assuming random order — the stochastic inner
    ICP reads scene_pts[:icp_scene_subset] (ops/pso.py). Measured before
    the shuffle: tracked mug-noisy ADD-S 2.24 -> 3.30 mm because the ICP
    subset saw only half the image's row-residue stripes. The [n_out]
    permutation gather is ~us against the ~5 ms the bucket scheme saves
    over top_k at VGA.
    """
    H, W = valid.shape
    flat_p = points.reshape(-1, 3)
    flat_n = normals.reshape(-1, 3)
    flat_v = valid.reshape(-1)
    hw = H * W
    # bucket grid: gw = divisor of n_out closest to the aspect-matched
    # split (static, host-side)
    target = max(1.0, (n_out * W / max(H, 1)) ** 0.5)
    gw = min((d for d in range(1, n_out + 1) if n_out % d == 0),
             key=lambda d: abs(d - target))
    gh = n_out // gw
    Hq, Wq = -(-H // gh), -(-W // gw)
    key, k_perm = jax.random.split(key)
    pri = jax.random.uniform(key, (hw,))
    pri = jnp.where(flat_v, pri, 2.0)  # invalid last within each bucket
    p2 = jnp.pad(pri.reshape(H, W), ((0, Hq * gh - H), (0, Wq * gw - W)),
                 constant_values=2.0)
    # [Hq,gh,Wq,gw] -> buckets [gh*gw, Hq*Wq]; argmin over each lattice
    pt = p2.reshape(Hq, gh, Wq, gw).transpose(1, 3, 0, 2).reshape(
        n_out, Hq * Wq)
    k = jnp.argmin(pt, axis=1)                              # [n_out]
    perm = jax.random.permutation(k_perm, n_out)
    k = k[perm]
    pt_min = jnp.min(pt, axis=1)[perm]
    c = perm
    y = (k // Wq) * gh + c // gw
    x = (k % Wq) * gw + c % gw
    order = jnp.minimum(y * W + x, hw - 1)
    # weight gates on the winning PRIORITY (< 1.5 iff a valid pixel won):
    # an all-invalid bucket's decoded index may alias a real pixel (row
    # wrap / padded-residue buckets when gh > H) and flat_v[order] alone
    # would resurrect it
    w = (pt_min < 1.5).astype(points.dtype)
    p = flat_p[order]
    n = flat_n[order]
    # Push padding points far away so any distance-based op naturally ignores
    # them even before weighting.
    p = jnp.where(w[:, None] > 0, p, 1e6)
    n = jnp.where(w[:, None] > 0, n, 0.0)
    return p, n, w


def preprocess_frame(
    key: jax.Array,
    depth_m: jax.Array,
    *,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    depth_min: float,
    depth_max: float,
    n_points: int,
    render_factor: int = 1,
    extra_invalid: jax.Array | None = None,
    outlier_tau: float = 0.0,
    outlier_min_neighbors: int = 2,
) -> SceneCloud:
    """depth (meters, [H,W]) -> SceneCloud. One fused XLA program.

    `extra_invalid` [H,W] bool marks pixels to drop (e.g. rendered hand
    mask from segmentation — applied by the estimator after hand FK).
    `outlier_tau` > 0 enables grid statistical outlier removal
    (speckle_mask) before normals/subsampling.
    """
    in_rng = (depth_m > depth_min) & (depth_m < depth_max) & jnp.isfinite(depth_m)
    valid = in_rng
    if extra_invalid is not None:
        valid = valid & (~extra_invalid)
    if outlier_tau > 0.0:
        valid = speckle_mask(
            depth_m, valid, tau=outlier_tau,
            min_neighbors=outlier_min_neighbors,
        )
    # measured-but-excluded pixels (hand drop, speckle): no-evidence class
    neutral_full = in_rng & (~valid)
    depth_c = jnp.where(valid, depth_m, 0.0)
    cloud = camera.backproject(depth_c, fx, fy, cx, cy)
    normals = camera.grid_normals(cloud, valid)
    # Points whose normal failed (grid edge / neighbors invalid) are dropped:
    # point-to-plane ICP needs normals. Note scene normals are optional in the
    # cost (we use model normals), but keeping only well-conditioned points
    # removes depth discontinuity pixels.
    nvalid = valid & (jnp.sum(normals * normals, axis=-1) > 0.5)
    pts, nrm, w = subsample_cloud(key, cloud, normals, nvalid, n_points)
    d_lo, v_lo = downsample_depth(depth_c, valid, render_factor)
    n_lo = downsample_mask_any(neutral_full, render_factor)
    return SceneCloud(points=pts, normals=nrm, weights=w, depth=d_lo,
                      valid=v_lo, depth_full=depth_c, valid_full=valid,
                      neutral=n_lo, neutral_full=neutral_full)
