"""Point-to-plane ICP as a batched Gauss-Newton tensor program.

Rebuild of the reference's per-hypothesis refinement
(SURVEY.md §3 "Point-to-plane ICP": ~30 Gauss-Newton iterations of
min_T sum_i ((s_i - T m_j(i)) . n_j(i))^2 with PCL KD-tree
correspondences, serial C++ per particle). Redesign:

  - correspondences: a fused brute-force distance + argmin pass
    (ops/knn.py);
  - the 6x6 normal equations are built with one einsum over points;
  - iterations are a lax.scan with a FIXED trip count — convergence is
    handled by freezing (converged hypotheses take zero-size steps), so
    shapes stay static under jit (SURVEY.md §8 hard part 5);
  - the particle axis is a vmap: 512 hypotheses refine as one device
    program instead of 512 serial C++ loops (BASELINE.json north star).

Direction convention: `pose` maps MODEL frame -> CAMERA frame. Scene
points are fixed observations; each ICP iteration matches scene points
to the posed model cloud and left-multiplies the pose with exp(xi).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import se3
from . import knn

_PREC = jax.lax.Precision.HIGHEST


class IcpStats(NamedTuple):
    rmse: jax.Array        # weighted point-to-plane RMSE of final iterate
    inliers: jax.Array     # sum of correspondence weights
    converged: jax.Array   # bool: step norm below threshold at exit
    support: jax.Array     # [P] weighted fraction of scene points within
                           # support_tau of the posed model surface (zeros
                           # when support_tau == 0). A byproduct of the
                           # last correspondence search: the NN direction
                           # here is scene -> posed model, so d2 IS the
                           # observation-side explanation distance (see
                           # ops/pso.py scene-coverage term)


def correspondence_weights(
    d2: jax.Array,
    scene_normals: jax.Array,
    model_normals_cam: jax.Array,
    scene_weights: jax.Array,
    max_corresp_dist: float,
    min_normal_cos: float,
) -> jax.Array:
    """Gate correspondences: distance, normal compatibility, padding.

    Mirrors the reference's correspondence rejection (max distance and
    normal-angle gates around its KD-tree search). Returns [Ns] weights
    in {0, 1} * scene_weights.
    """
    w = scene_weights
    w = w * (d2 < max_corresp_dist * max_corresp_dist)
    ncos = jnp.sum(scene_normals * model_normals_cam, axis=-1)
    # scene normals can be zero (padding); only gate where both normals exist
    have_n = (jnp.sum(scene_normals * scene_normals, -1) > 0.5) & (
        jnp.sum(model_normals_cam * model_normals_cam, -1) > 0.5
    )
    w = w * jnp.where(have_n, (ncos > min_normal_cos).astype(w.dtype), 1.0)
    return w


def cholesky_solve6(H: jax.Array, g: jax.Array) -> jax.Array:
    """Solve H x = g for SPD H [...,6,6], g [...,6], fully unrolled.

    jnp.linalg.solve on a [P,6,6] batch lowers to a batched LU with
    pivoting. Unrolling the 6x6 Cholesky turns the whole batched solve
    into ~100 elementwise ops over the particle axis, which XLA fuses.
    """
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        # clamp: padding/degenerate batches must not NaN the whole swarm
        L[j][j] = jnp.sqrt(jnp.maximum(s, 1e-20))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    # forward substitution L y = g
    y = [None] * n
    for i in range(n):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x, axis=-1)


def solve_gn_step(
    scene_pts: jax.Array,     # [...,Ns,3]
    matched_pts: jax.Array,   # [...,Ns,3] posed model points matched to scene
    normals: jax.Array,       # [...,Ns,3] matched model normals, camera frame
    weights: jax.Array,       # [...,Ns]
    damping: float,
) -> tuple[jax.Array, jax.Array]:
    """One damped Gauss-Newton step of point-to-plane alignment; batched
    over arbitrary leading axes.

    Linearizes r_i(xi) = n_i . (s_i - exp(xi) p_i) around xi=0:
    J_i = -[ (p_i x n_i), n_i ], so  (J^T W J + lam I) xi = J^T W r with
    J^T W r = sum w_i r_i [p_i x n_i; n_i]. Returns (xi [...,6], rmse).
    """
    r = jnp.sum(normals * (scene_pts - matched_pts), axis=-1)   # [...,Ns]
    pxn = jnp.cross(matched_pts, normals)                        # [...,Ns,3]
    J = jnp.concatenate([pxn, normals], axis=-1)                 # [...,Ns,6]
    wJ = J * weights[..., None]
    H = jnp.einsum("...ni,...nj->...ij", wJ, J, precision=_PREC)  # [...,6,6]
    g = jnp.einsum("...ni,...n->...i", wJ, r, precision=_PREC)    # [...,6]
    # Scale-aware Levenberg damping keeps the solve well-posed when
    # correspondences are degenerate (few inliers, flat geometry).
    tr = jnp.trace(H, axis1=-2, axis2=-1)
    lam = damping * (tr / 6.0 + 1e-12)
    H = H + lam[..., None, None] * jnp.eye(6, dtype=H.dtype)
    xi = cholesky_solve6(H, g)
    wsum = jnp.maximum(jnp.sum(weights, axis=-1), 1e-9)
    rmse = jnp.sqrt(jnp.sum(weights * r * r, axis=-1) / wsum)
    # With zero inliers the system is pure damping and xi ~ g/lam garbage:
    # freeze instead.
    xi = jnp.where(
        (jnp.sum(weights, axis=-1) > 6.0)[..., None], xi, 0.0
    )
    return xi, rmse


def icp_batched(
    poses0: jax.Array,         # [P,4,4]
    scene_pts: jax.Array,      # [Ns,3] shared observations
    scene_normals: jax.Array,  # [Ns,3] (zeros allowed)
    scene_weights: jax.Array,  # [Ns]
    model_pts: jax.Array,      # [Nm,3] model frame
    model_normals: jax.Array,  # [Nm,3] model frame
    *,
    iters: int = 30,
    max_corresp_dist: float = 0.02,
    normal_angle_max_deg: float = 60.0,
    damping: float = 1e-6,
    step_scale: float = 1.0,
    converge_tol: float = 1e-6,
    gn_reps: int = 1,
    support_tau: float = 0.0,
) -> tuple[jax.Array, IcpStats]:
    """Batched point-to-plane ICP, natively tensorized over the particle
    axis (BASELINE.json config-2 "batched 64-particle refine"): all P
    hypotheses share one scene; each iteration is ONE [P,Ns,Nm]
    correspondence search + gn_reps batched GN solves — not P programs.

    Fixed iteration count (jit/vmap/scan safe); per-particle convergence
    via freezing (SURVEY.md §8 hard part 5). Correspondences come from
    the fused brute-force search `knn.nn_gather_batched`.

    support_tau > 0 additionally reports IcpStats.support: the
    scene_weights-weighted fraction of scene points whose NN distance to
    the posed model cloud is below support_tau, from the LAST
    correspondence search (so at most one GN step stale — sub-mm here).
    Free: d2 is already computed every iteration.
    """
    P = poses0.shape[0]
    min_cos = math.cos(math.radians(normal_angle_max_deg))
    # Anchor the GN solve at the weighted scene centroid: rotations about
    # the camera origin are mostly translations for objects ~0.5m out,
    # which wrecks both the 6x6 conditioning and the linearization.
    wsum = jnp.maximum(jnp.sum(scene_weights), 1e-9)
    anchor = jnp.sum(scene_pts * scene_weights[:, None], axis=0) / wsum

    def _support(d2):
        if support_tau <= 0:
            return jnp.zeros(d2.shape[:-1], d2.dtype)
        hit = (d2 < support_tau * support_tau).astype(d2.dtype)
        return jnp.sum(hit * scene_weights[None], axis=-1) / wsum

    scene_c = scene_pts - anchor                                  # [Ns,3]
    apply_twists = jax.vmap(se3.apply_twist_about, in_axes=(0, 0, None))

    def body(carry, _):
        poses, frozen = carry                                     # [P,4,4],[P]
        posed = se3.transform_points(poses, model_pts)            # [P,Nm,3]
        mnorm_all = se3.rotate_vectors(poses, model_normals)      # [P,Nm,3]
        matched, mnorm, d2, _ = knn.nn_gather_batched(
            scene_pts, posed, mnorm_all)
        w = correspondence_weights(
            d2, scene_normals[None], mnorm, scene_weights[None],
            max_corresp_dist, min_cos,
        )                                                         # [P,Ns]
        # correspondence reuse: gn_reps damped GN re-linearizations on the
        # SAME matched pairs (re-posed by each increment) — the NN search
        # dominates ICP cost, extra GN solves are nearly free (LM-ICP
        # style inner iterations). Gates (w) stay from the search pose.
        m_c = matched - anchor                                    # [P,Ns,3]
        nrm = mnorm
        for rep in range(gn_reps):
            xi, rmse = solve_gn_step(scene_c[None], m_c, nrm, w, damping)
            xi = xi * step_scale
            step = jnp.sum(xi * xi, axis=-1)                      # [P]
            frozen = frozen | (step < converge_tol * converge_tol)
            xi = jnp.where(frozen[:, None], 0.0, xi)
            poses = apply_twists(xi, poses, anchor)
            if rep + 1 < gn_reps:
                E = se3.se3_exp(xi)                               # [P,4,4]
                m_c = se3.transform_points(E, m_c)
                nrm = se3.rotate_vectors(E, nrm)
        return (poses, frozen), (rmse, jnp.sum(w, axis=-1), _support(d2))

    (poses, frozen), (rmses, inliers, supports) = jax.lax.scan(
        body, (poses0, jnp.zeros((P,), bool)), None, length=iters
    )
    stats = IcpStats(rmse=rmses[-1], inliers=inliers[-1], converged=frozen,
                     support=supports[-1])
    return poses, stats


def scene_support(
    poses: jax.Array,          # [P,4,4]
    scene_pts: jax.Array,      # [Ns,3]
    scene_weights: jax.Array,  # [Ns]
    model_pts: jax.Array,      # [Nm,3]
    *,
    tau: float,
) -> jax.Array:
    """Observation-side support: weighted fraction of scene points within
    `tau` of the posed model cloud, per pose ([P]).

    This is the direction render-and-compare cannot see: every observed
    object point is hard evidence of object surface THERE, with no
    occlusion asymmetry (an unexplained observed point falsifies the
    pose, while an unseen model region never can). Used by ops/pso.py to
    break explain-the-visible-half ambiguities (measured r3: a box slid
    ~48 mm along its axis hid its protruding end behind the hand-dropped
    region and OUT-SCORED truth 1.455 vs 1.335; its support was 0.57 vs
    truth's 0.99 at tau=10 mm)."""
    posed = se3.transform_points(poses, model_pts)
    _, d2 = knn.nn_batched(scene_pts, posed)
    hit = (d2 < tau * tau).astype(d2.dtype)
    wsum = jnp.maximum(jnp.sum(scene_weights), 1e-9)
    return jnp.sum(hit * scene_weights[None], axis=-1) / wsum


def icp(
    pose0: jax.Array,          # [4,4] model->camera initial pose
    scene_pts: jax.Array,
    scene_normals: jax.Array,
    scene_weights: jax.Array,
    model_pts: jax.Array,
    model_normals: jax.Array,
    **kwargs,
) -> tuple[jax.Array, IcpStats]:
    """Single-hypothesis point-to-plane ICP (BASELINE.json config 1) —
    the P=1 slice of the batched path."""
    poses, stats = icp_batched(
        pose0[None], scene_pts, scene_normals, scene_weights,
        model_pts, model_normals, **kwargs,
    )
    return poses[0], jax.tree_util.tree_map(lambda a: a[0], stats)
