"""Render-and-compare hypothesis scoring with finger-occlusion masking.

Rebuild of the reference's per-particle scoring (SURVEY.md §3
"Render-and-compare scorer": rendered vs observed depth residual,
wrong-side penalties, finger-occlusion masking so points hidden behind
fingers are not penalized). Here the whole thing is an elementwise
tensor program over [P,H,W] — all P particles score in one fused pass
(BASELINE.json north star).

Fitness is HIGHER-better in [~ -wrong_side_penalty, 1]:

  per rendered-object pixel (object hypothesis depth d_r finite):
    - hand-occluded (hand depth < d_r - margin): EXCLUDED — the finger
      hides the object there; no evidence either way.
    - observed valid, |d_r - d_obs| < tau: support  1 - |diff|/tau.
    - observed valid, d_r < d_obs - tau: the hypothesis floats in front
      of a measured surface — physically impossible (the camera would
      have seen it) -> wrong-side penalty.
    - observed valid, d_r > d_obs + tau: hypothesis behind an observed
      surface that segmentation did not assign to the hand: counted,
      no support.
    - observed invalid (no depth return): GHOST pixel — the hypothesis
      renders where the camera measured nothing. For a depth camera,
      no-return over the working range is (weak) negative evidence, so
      ghosts enter the denominator with a small penalty. Without this a
      pose drifting into unobserved space sheds all its evidence pixels
      and scores near-perfect on the few that remain (observed failure
      mode: 71mm-wrong pose, fitness 0.99, coverage 0.007).

  fitness = (sum support - wrong_side_penalty * n_wrong
             - invalid_penalty * n_ghost) / n_counted
  coverage = n_support / n_object_pixels_observed  (how much of the
  observed object cloud the hypothesis explains; used by the tracking
  watchdog, BASELINE config 4).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class ScoreTerms(NamedTuple):
    fitness: jax.Array    # [...,] higher better
    coverage: jax.Array   # [...,] in [0,1]
    support: jax.Array    # [...,] sum of per-pixel support
    counted: jax.Array    # [...,] pixels with evidence


# invalid-pixel classes in the encoded observed image (encode_observed)
_FAR = 1e9      # no return, not adjacent to the silhouette -> ghost penalty
_NEAR = -1.0    # no return but within ghost_dilate px of a return: no ghost
                # penalty (silhouette tolerance band)
_NEUTRAL = -2.0  # measured in range but excluded from evidence by
                # segmentation (hand drop, speckle): no ghost penalty, and
                # exempt from the coverage denominator when
                # neutral_cov_exempt is set (init-mode scoring — see
                # compare_points). All sentinels exactly bf16-representable:
                # the one-hot gather tables split them hi/lo without rounding.


def encode_observed(
    observed: jax.Array,        # [H,W] depth, 0 invalid
    observed_valid: jax.Array,  # [H,W] bool
    ghost_dilate: int = 1,
    neutral: jax.Array | None = None,  # [H,W] measured-but-excluded px
) -> jax.Array:
    """Fold (depth, valid, near-silhouette, neutral) into ONE image so
    point scoring classifies each sample with a single gather: valid
    pixels carry their depth, no-return pixels carry _NEAR within
    `ghost_dilate` px of a valid return (silhouette tolerance band —
    neutral evidence) and _FAR beyond it (ghost penalty). `neutral` marks
    pixels the camera measured in range that segmentation excluded (hand
    drop, speckle — preprocess.SceneCloud.neutral_full): they are NOT
    free space, so a hypothesis rendering onto them is no-evidence
    (_NEUTRAL — never a ghost). Without this class a grasped true pose
    pays the ghost penalty on every sample the hand drop conservatively
    took away (measured: 34/206 visible samples at box init t=17, enough
    for a 24 mm slide to win the fine tier). Both no-evidence classes
    still count in the coverage denominator — see the measured rationale
    at the denominator in compare_points. Called once per frame/tier in
    ops/pso.py, OUTSIDE the scan, so the dilation is never recomputed in
    the hot loop."""
    if ghost_dilate > 0:
        k = 2 * ghost_dilate + 1
        near = jax.lax.reduce_window(
            observed_valid, False, jax.lax.bitwise_or,
            window_dimensions=(k, k), window_strides=(1, 1), padding="SAME",
        )
        fill = jnp.where(near, _NEAR, _FAR)
    else:
        fill = jnp.full_like(observed, _FAR)
    if neutral is not None:
        fill = jnp.where(neutral, _NEUTRAL, fill)
    return jnp.where(observed_valid, observed, fill)


def compare_depth(
    rendered: jax.Array,    # [...,H,W] object hypothesis depth (+inf empty)
    observed: jax.Array,    # [H,W] observed depth (0 invalid)
    observed_valid: jax.Array,  # [H,W] bool
    hand_depth: jax.Array | None = None,  # [H,W] (+inf none)
    *,
    depth_tau: float = 0.01,
    wrong_side_penalty: float = 2.0,
    occlusion_margin: float = 0.005,
    invalid_penalty: float = 0.3,
    ghost_dilate: int = 1,
    observed_enc: jax.Array | None = None,
) -> ScoreTerms:
    """Score rendered depth(s) against one observed frame. Broadcasts over
    leading particle axes of `rendered`. `ghost_dilate`: rendered pixels
    within that many px of a valid return are not ghosts (silhouette
    tolerance — see compare_points). `observed_enc` (encode_observed
    output) carries the dilation precomputed, so pixel-mode scoring
    inside the PSO scan does not re-evaluate the loop-invariant
    reduce_window every iteration (ADVICE r2)."""
    r_valid = jnp.isfinite(rendered)
    if hand_depth is not None:
        occluded = hand_depth[None] < (rendered - occlusion_margin) if rendered.ndim == 3 else (
            hand_depth < rendered - occlusion_margin
        )
        visible = r_valid & (~occluded)
    else:
        visible = r_valid

    obs = jnp.where(observed_valid, observed, jnp.inf)
    diff = rendered - obs                         # broadcast [...,H,W]
    absdiff = jnp.abs(diff)

    counted_px = visible & observed_valid
    match = counted_px & (absdiff < depth_tau)
    wrong = counted_px & (diff < -depth_tau)      # floats in front of evidence
    if observed_enc is not None:
        not_near = observed_enc >= 0.5 * _FAR
    else:
        not_near = ~observed_valid
        if ghost_dilate > 0:
            k = 2 * ghost_dilate + 1
            not_near = ~jax.lax.reduce_window(
                observed_valid, False, jax.lax.bitwise_or,
                window_dimensions=(k, k), window_strides=(1, 1), padding="SAME",
            )
    ghost = visible & (~observed_valid) & not_near  # renders over no-return

    support_px = jnp.where(match, 1.0 - absdiff / depth_tau, 0.0)
    axes = (-1, -2)
    support = jnp.sum(support_px, axis=axes)
    n_wrong = jnp.sum(wrong.astype(rendered.dtype), axis=axes)
    n_ghost = jnp.sum(ghost.astype(rendered.dtype), axis=axes)
    n_counted = jnp.sum(counted_px.astype(rendered.dtype), axis=axes) + n_ghost

    fitness = (
        support - wrong_side_penalty * n_wrong - invalid_penalty * n_ghost
    ) / jnp.maximum(n_counted, 1.0)
    # padding/degenerate renders (nothing visible) must lose to anything real
    fitness = jnp.where(n_counted > 0, fitness, -wrong_side_penalty)

    n_obs = jnp.maximum(jnp.sum(observed_valid.astype(rendered.dtype)), 1.0)
    coverage = jnp.sum(match.astype(rendered.dtype), axis=axes) / n_obs
    return ScoreTerms(fitness=fitness, coverage=coverage, support=support, counted=n_counted)


def pack_quad(enc: jax.Array) -> jax.Array:
    """[H,W] encoded image -> [(H+1)*(W+1), 4] per-cell 2x2 neighborhoods.

    Row (v0+1)*(W+1)+(u0+1) holds [enc[v0,u0], enc[v0,u0+1],
    enc[v0+1,u0], enc[v0+1,u0+1]] with a _FAR border, so the subpixel
    scorer fetches all four bilinear corners with ONE gather instead of
    four — gathers are the dominant cost of the fine scoring tier
    (measured r2: the finisher was 55% of the frame at 4 gathers/sample).
    """
    ep = jnp.pad(enc, ((1, 1), (1, 1)), constant_values=_FAR)  # [H+2,W+2]
    q = jnp.stack(
        [ep[:-1, :-1], ep[:-1, 1:], ep[1:, :-1], ep[1:, 1:]], axis=-1
    )                                                          # [H+1,W+1,4]
    return q.reshape(-1, 4)


def _bilinear_depth(
    u: jax.Array,            # [...,N] continuous pixel x (pixel centers at ints)
    v: jax.Array,            # [...,N]
    inb: jax.Array,          # [...,N] projection in bounds (nearest-pixel)
    enc: jax.Array,          # [H,W] encoded observed image (encode_observed)
    *,
    height: int, width: int,
    edge_tau: float,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Edge-aware bilinear sample of an ENCODED observed depth map.

    Returns (depth, valid, e_ref) where e_ref is the nearest corner's
    encoded value (its class decides ghost/neutral for invalid samples).
    Neighbors are weighted by bilinear weights, masked by validity AND by
    |d_k - d_nearest| < edge_tau so depth discontinuities do not blend
    across an edge; when the nearest pixel is invalid the sample is
    invalid (matching nearest-gather semantics). All four corners come
    from ONE gather of the quad-packed image (pack_quad).

    Invalid pixels carry large FINITE sentinels (encode_observed), never
    inf: two invalid corners would otherwise produce inf-inf = NaN in
    the edge test — harmless (masked) but it trips jax_debug_nans, which
    CI runs a frame under (SURVEY.md §6 sanitizers).
    """
    packed = pack_quad(enc)
    u0 = jnp.floor(u)
    v0 = jnp.floor(v)
    u0i = u0.astype(jnp.int32)
    v0i = v0.astype(jnp.int32)
    # inb (nearest pixel in range) implies u0 in [-1, W-1], v0 likewise,
    # which the _FAR border of the packed table covers exactly
    base = jnp.where(inb, (v0i + 1) * (width + 1) + (u0i + 1), 0)
    quad = jnp.take(packed, base, axis=0)                      # [...,N,4]
    return _edge_aware_combine(
        u - u0, v - v0, inb,
        [quad[..., k] for k in range(4)], edge_tau,
    )


def _edge_aware_combine(
    au: jax.Array, av: jax.Array, inb: jax.Array,
    corners: list[jax.Array],    # [d00, d01, d10, d11] encoded values
    edge_tau: float,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Edge-aware bilinear combination of the four 2x2 corner values
    (encoded-image semantics; shared by the quad-gather and one-hot-gather
    corner fetchers — identical math, so the two paths agree to the
    corner values' precision)."""
    d_corner, w_corner, m_corner = [], [], []
    for k, (dv, du) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        d = corners[k]
        w = (au if du else 1.0 - au) * (av if dv else 1.0 - av)
        d_corner.append(d)
        w_corner.append(w)
        m_corner.append(inb & (d > 0.0) & (d < 0.5 * _FAR))
    # nearest corner = the one the rounded gather would hit
    near_u = au >= 0.5
    near_v = av >= 0.5
    sel = [(~near_u & ~near_v), (near_u & ~near_v),
           (~near_u & near_v), (near_u & near_v)]
    d_ref = sum(jnp.where(s, d, 0.0) for s, d in zip(sel, d_corner))
    ref_ok = sum(jnp.where(s, m.astype(au.dtype), 0.0)
                 for s, m in zip(sel, m_corner)) > 0.5

    num = jnp.zeros_like(au)
    den = jnp.zeros_like(au)
    for d, w, m in zip(d_corner, w_corner, m_corner):
        wk = w * m * (jnp.abs(d - d_ref) < edge_tau)
        num = num + wk * jnp.where(m, d, 0.0)
        den = den + wk
    valid = ref_ok & (den > 1e-6)
    depth = jnp.where(valid, num / jnp.maximum(den, 1e-6), 0.0)
    return depth, valid, d_ref


def compare_points(
    pts_cam: jax.Array,      # [...,N,3] posed model surface samples
    normals_cam: jax.Array,  # [...,N,3] posed outward model normals
    observed: jax.Array,     # [H,W] observed depth (0 invalid)
    observed_valid: jax.Array,  # [H,W] bool
    hand_depth: jax.Array | None = None,  # [H,W] (+inf none)
    *,
    fx: float, fy: float, cx: float, cy: float,
    height: int, width: int,
    depth_tau: float = 0.01,
    wrong_side_penalty: float = 2.0,
    occlusion_margin: float = 0.005,
    invalid_penalty: float = 0.3,
    subpixel: bool = False,
    ghost_dilate: int = 1,
    observed_enc: jax.Array | None = None,
    mxu_tables: tuple | None = None,
    neutral_cov_exempt: bool = False,
    sample_mask: jax.Array | None = None,  # [N] bool: sample participates
                       # (frame-constant visibility from the incumbent
                       # pose — second-order self-occlusion, see
                       # estimator._search; candidate-independent so it
                       # is rank-neutral across the swarm)
    mask_count_floor: float = 0.5,  # masked-path denominator floor as a
                       # fraction of the UNMASKED counted set — see the
                       # fitness block below for the failure mode this
                       # guards (far candidates become denominator-
                       # fragile lottery tickets without it)
) -> ScoreTerms:
    """Point-wise render-and-compare: projective association instead of a
    per-particle z-buffer.

    The pixel path (`compare_depth`) needs a scatter-min splat per
    particle per PSO iteration. This path renders NOTHING: each posed model
    sample gathers the observed depth at its projected pixel and is
    classified exactly like a rendered pixel would be. Self-occlusion
    (the z-buffer's job) is approximated by back-face culling: samples
    whose outward normal faces away from the camera are excluded — the
    first-order visibility model (validated against the exact z-buffer
    on concave meshes in test_score_concave.py). Same fitness semantics,
    per point instead of per pixel; coverage = matched fraction of the
    front-facing samples.

    subpixel=True replaces the nearest-pixel depth gather with an
    EDGE-AWARE BILINEAR one (4 gathers instead of 1): nearest-pixel
    rounding quantizes the observed surface at ~(z/f) meters per pixel —
    0.9 mm at f=570 px, z=0.5 m — exactly the accuracy floor VERDICT r1
    measured. Bilinear interpolation is only taken over neighbors whose
    depth lies within `3*depth_tau` of the nearest pixel's depth, so
    silhouette/occlusion discontinuities fall back to nearest instead of
    smearing foreground into background. Used at the fine scoring tier
    (polish + finisher, ops/pso.py); the in-scan coarse tier keeps the
    single gather.

    mxu_tables replaces every image gather (observed depth AND hand
    occlusion) with separable one-hot matmuls (ops/gather_mxu). Two
    forms:

      ("image", enc_hi, enc_lo, hand_hi, hand_lo) — full-image lookups
      (coarse/low-res tier). enc_* = gather_mxu.split_bf16 of
      encode_observed(...); hand_* = split of the hand depth with +inf
      replaced by a large finite sentinel (split_bf16(inf) would
      produce NaN and occlusion tests handle 1e9 fine), or None.

      ("patch", enc_hi, enc_lo, hand_hi, hand_lo, pv0, pu0) — per-point
      [N,S,S] patches around one reference pose's sample projections
      with patch origins pv0/pu0 [N] (finisher tier: mm-scale
      perturbations keep samples inside their patches, and a
      full-VGA-width one-hot operand would be GBs).

    Exact to double-bf16 precision (~3 um at 0.5 m). Hot callers
    (ops/pso.py) build the tables once per frame/tier outside the scans.
    """
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    in_front = z > 1e-6
    zs = jnp.where(in_front, z, 1.0)
    u = x / zs * fx + cx
    v = y / zs * fy + cy
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    inb = in_front & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    # back-face cull: outward normal must face the camera (n . p < 0)
    facing = jnp.sum(normals_cam * pts_cam, axis=-1) < 0.0
    vis = inb & facing

    # One encoded image carries depth + the ghost/neutral class of every
    # invalid pixel (encode_observed): classification stays a single
    # gather. The silhouette-tolerance band exists because boundary
    # samples of an exactly-correct pose land on no-return pixels just
    # outside the silhouette (half-pixel rasterization + sensor edge
    # dropout) and the invalid_penalty would systematically squeeze the
    # pose inward/backward — a measured ~1-2 mm bias on flat objects.
    # Samples projecting FAR into unobserved space (the 71 mm drift
    # failure mode) still pay. Hot callers (ops/pso.py) precompute
    # `observed_enc` once per frame/tier OUTSIDE the scan.
    if mxu_tables is not None:
        from . import gather_mxu

        if mxu_tables[0] == "patch":
            # per-point patches (finisher tier): lookups in patch-local
            # coordinates; out-of-patch samples read 0.0 = no evidence
            _, enc_hi, enc_lo, hand_hi, hand_lo, pv0, pu0 = mxu_tables
            if subpixel:
                u0 = jnp.floor(u)
                v0 = jnp.floor(v)
                corners = gather_mxu.take_patch_corners(
                    enc_hi, enc_lo,
                    v0.astype(jnp.int32) - pv0, u0.astype(jnp.int32) - pu0,
                )
                d_obs, v_obs, e_ref = _edge_aware_combine(
                    u - u0, v - v0, inb, list(corners), 3.0 * depth_tau,
                )
            else:
                e_ref = gather_mxu.take_patches(
                    enc_hi, enc_lo, vi - pv0, ui - pu0)
                v_obs = inb & (e_ref > 0.0) & (e_ref < 0.5 * _FAR)
                d_obs = e_ref
            if hand_hi is not None:
                d_hand = gather_mxu.take_patches(
                    hand_hi, hand_lo, vi - pv0, ui - pu0)
                vis = vis & ~(
                    (d_hand > 0.0) & (d_hand < z - occlusion_margin))
        else:
            _, enc_hi, enc_lo, hand_hi, hand_lo = mxu_tables
            if subpixel:
                u0 = jnp.floor(u)
                v0 = jnp.floor(v)
                corners = gather_mxu.take_image_corners(
                    enc_hi, enc_lo,
                    v0.astype(jnp.int32), u0.astype(jnp.int32),
                )
                d_obs, v_obs, e_ref = _edge_aware_combine(
                    u - u0, v - v0, inb, list(corners), 3.0 * depth_tau,
                )
            else:
                e_ref = gather_mxu.take_image(enc_hi, enc_lo, vi, ui)
                v_obs = inb & (e_ref > 0.0) & (e_ref < 0.5 * _FAR)
                d_obs = e_ref
            if hand_hi is not None:
                d_hand = gather_mxu.take_image(hand_hi, hand_lo, vi, ui)
                # out-of-range lookups return exactly 0.0 (all-zero
                # one-hot), which must not read as "occluded at depth 0"
                vis = vis & ~(
                    (d_hand > 0.0) & (d_hand < z - occlusion_margin))
    else:
        if observed_enc is None:
            observed_enc = encode_observed(
                observed, observed_valid, ghost_dilate)
        enc_flat = observed_enc.reshape(-1)
        flat = jnp.where(inb, vi * width + ui, 0)
        if subpixel:
            d_obs, v_obs, e_ref = _bilinear_depth(
                u, v, inb, observed_enc,
                height=height, width=width, edge_tau=3.0 * depth_tau,
            )
        else:
            e_ref = jnp.take(enc_flat, flat)
            v_obs = inb & (e_ref > 0.0) & (e_ref < 0.5 * _FAR)
            d_obs = e_ref
        if hand_depth is not None:
            d_hand = jnp.take(hand_depth.reshape(-1), flat)
            vis = vis & ~(d_hand < z - occlusion_margin)

    # The incumbent-visibility mask is applied LAST (after the hand-
    # occlusion culls above) so `vis0` below is the exact unmasked
    # equivalent of `vis` for the denominator floor.
    vis0 = vis
    if sample_mask is not None:
        vis = vis & sample_mask

    diff = z - jnp.where(v_obs, d_obs, jnp.inf)
    absdiff = jnp.abs(diff)
    counted = vis & v_obs
    match = counted & (absdiff < depth_tau)
    wrong = counted & (diff < -depth_tau)
    ghost = vis & (e_ref >= 0.5 * _FAR)

    dt = pts_cam.dtype
    support_pt = jnp.where(match, 1.0 - absdiff / depth_tau, 0.0)
    support = jnp.sum(support_pt, axis=-1)
    n_wrong = jnp.sum(wrong.astype(dt), axis=-1)
    n_ghost = jnp.sum(ghost.astype(dt), axis=-1)
    n_counted = jnp.sum(counted.astype(dt), axis=-1) + n_ghost

    n_den = jnp.maximum(n_counted, 1.0)
    if sample_mask is not None:
        # Denominator FLOOR at a fraction of the UNMASKED counted set.
        # The mask is frame-constant so it is rank-neutral NEAR the
        # incumbent, but a far candidate (explorer seed, flip
        # hypothesis) faces the camera with the half of the model the
        # incumbent mask culled: its counted set collapses to a sliver
        # and support/n_counted becomes a high-variance lottery ticket —
        # measured r5 (tiny verify config): per-frame ADD-S 4.8 -> 58.9
        # mm with the raw masked denominator, bitwise-identical to
        # unmasked with an all-true mask (plumbing no-op pinned by
        # tests). Flooring at mask_count_floor * unmasked count leaves
        # near-incumbent ranking untouched (their masked count sits
        # above the floor unless the shape hides > that fraction of
        # itself) and scales far candidates' fitness by their true
        # evidence fraction instead of their surviving sliver.
        counted0 = vis0 & v_obs
        ghost0 = vis0 & (e_ref >= 0.5 * _FAR)
        n0 = (jnp.sum(counted0.astype(dt), axis=-1)
              + jnp.sum(ghost0.astype(dt), axis=-1))
        n_den = jnp.maximum(n_den, mask_count_floor * n0)

    fitness = (
        support - wrong_side_penalty * n_wrong - invalid_penalty * n_ghost
    ) / n_den
    fitness = jnp.where(n_counted > 0, fitness, -wrong_side_penalty)

    # coverage denominator: by default ALL front-facing in-bounds
    # samples, including those on no-evidence pixels (_NEAR band,
    # _NEUTRAL). Universal exemptions regressed the pinned tracking
    # gates: exempting the _NEAR band blunted mm discrimination (asym
    # clean frame-0 1.0 -> 3.2 mm), and always exempting _NEUTRAL
    # created a gradient TOWARD the hand region — hiding samples on
    # dropped pixels inflates coverage for drifted poses as much as for
    # truth (asym noisy 1.8 -> >2.4 mm). `neutral_cov_exempt` enables
    # the _NEUTRAL exemption for GLOBAL REGISTRATION only (the estimator
    # flips it for its init program): there candidates differ by tens of
    # millimeters and the grasped true pose must not lose the ranking
    # for coverage it physically cannot have (box/cyl frame-0 init
    # 19/20 -> 20/20 at reduced res).
    n_vis = jnp.sum(vis.astype(dt), axis=-1)
    if neutral_cov_exempt:
        no_ev = vis & (e_ref < 0.5 * (_NEAR + _NEUTRAL))
        n_vis = n_vis - jnp.sum(no_ev.astype(dt), axis=-1)
    n_vis = jnp.maximum(n_vis, 1.0)
    if sample_mask is not None:
        # same sliver guard as the fitness denominator: coverage feeds
        # the best-hypothesis selection and the reinit watchdog
        n_vis = jnp.maximum(
            n_vis, mask_count_floor * jnp.sum(vis0.astype(dt), axis=-1))
    coverage = jnp.sum(match.astype(dt), axis=-1) / n_vis
    return ScoreTerms(
        fitness=fitness, coverage=coverage, support=support, counted=n_counted
    )
