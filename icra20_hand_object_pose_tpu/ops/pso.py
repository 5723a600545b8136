"""Particle-swarm pose hypothesis optimization, as one lax.scan.

Rebuild of the reference's PSO loop (SURVEY.md §3 "PSO /
particle optimizer": swarm of pose particles, SE(3) perturbation,
render-and-compare scoring, personal/global best tracking, serial C++
loop per particle per iteration). Redesign (SURVEY.md §4.5):

  - the swarm is a `[P,4,4]` tensor axis, not a C++ loop: every PSO
    iteration renders, scores, and ICP-refines ALL particles as one
    device program (vmapped splat + [P,h,w] scoring + vmapped GN);
  - the iteration loop is a single `lax.scan`, so a whole frame's
    optimization is ONE XLA computation with zero host round-trips —
    the reference crosses the host<->GL boundary O(P * iters) times
    per frame (SURVEY.md §4.2);
  - the annealed perturb/elite-resample schedule replaces PSO velocity
    state: sigma decays geometrically, the worst `elite_frac` of the
    swarm teleports near the global best each iteration. This keeps
    swarm state at [P,4,4]+[P] (no velocity tensors) and is robust
    under the multimodal, occlusion-riddled fitness field;
  - ICP runs inside the scan every `icp_every` iterations under a
    `lax.cond`, on a fixed-size scene subset, so shapes stay static
    (SURVEY.md §8 hard part 5).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils import se3
from ..utils.config import IcpConfig, PsoConfig, ScoreConfig
from . import icp as icp_mod
from . import render, score


class PsoResult(NamedTuple):
    best_pose: jax.Array      # [4,4]
    best_fitness: jax.Array   # scalar
    best_coverage: jax.Array  # scalar, for the tracking watchdog
    poses: jax.Array          # [P,4,4] final swarm
    fitness: jax.Array        # [P] final swarm fitness
    fitness_trace: jax.Array  # [iters] best fitness per iteration
    cand_poses: jax.Array     # [C,4,4] fine-tier polished candidate set
    cand_fitness: jax.Array   # [C] (cross-shard gathered when sharded)
    cand_coverage: jax.Array  # [C]


def score_particles(
    poses: jax.Array,          # [P,4,4]
    render_pts: jax.Array,     # [Nr,3] model-frame surface samples
    render_normals: jax.Array,  # [Nr,3] outward normals (visibility)
    render_w: jax.Array,       # [Nr]
    observed_depth: jax.Array,  # [h,w] meters, 0 invalid
    observed_valid: jax.Array,  # [h,w] bool
    hand_depth: jax.Array,      # [h,w] +inf = no hand
    *,
    fx: float, fy: float, cx: float, cy: float,
    height: int, width: int,
    splat_radius: int,
    score_cfg: ScoreConfig,
    subpixel: bool = False,
    observed_enc: jax.Array | None = None,  # precomputed encode_observed
    mxu_tables: tuple | None = None,        # pre-split one-hot gather tables
    sample_mask: jax.Array | None = None,   # [Nr] frame-constant sample
                                            # visibility (self-occlusion)
) -> tuple[jax.Array, jax.Array]:
    """Render-and-compare fitness for every particle. Returns
    (fitness [P], coverage [P]).

    mode="point" (default): projective per-point association — no
    per-particle z-buffer; the whole swarm scores as two gathers + a
    fused elementwise pass (see score.compare_points for why).
    mode="pixel": batched splat render + per-pixel compare (the exact
    z-buffered semantics; one scatter-min splat per particle)."""
    pts_cam = se3.transform_points(poses, render_pts)      # [P,Nr,3]
    if score_cfg.mode == "point":
        nrm_cam = se3.rotate_vectors(poses, render_normals)
        terms = score.compare_points(
            pts_cam, nrm_cam, observed_depth, observed_valid, hand_depth,
            fx=fx, fy=fy, cx=cx, cy=cy, height=height, width=width,
            depth_tau=score_cfg.depth_tau,
            wrong_side_penalty=score_cfg.wrong_side_penalty,
            occlusion_margin=score_cfg.occlusion_margin,
            invalid_penalty=score_cfg.invalid_penalty,
            subpixel=subpixel,
            ghost_dilate=score_cfg.ghost_dilate,
            observed_enc=observed_enc,
            mxu_tables=mxu_tables,
            neutral_cov_exempt=score_cfg.neutral_cov_exempt,
            sample_mask=sample_mask,
            mask_count_floor=score_cfg.self_occ_count_floor,
        )
    else:
        if sample_mask is not None:
            render_w = render_w * sample_mask
        depths = render.splat_depth_batched(
            pts_cam, render_w, fx=fx, fy=fy, cx=cx, cy=cy,
            height=height, width=width, radius=splat_radius,
        )                                                   # [P,h,w]
        terms = score.compare_depth(
            depths, observed_depth, observed_valid, hand_depth,
            depth_tau=score_cfg.depth_tau,
            wrong_side_penalty=score_cfg.wrong_side_penalty,
            occlusion_margin=score_cfg.occlusion_margin,
            invalid_penalty=score_cfg.invalid_penalty,
            ghost_dilate=score_cfg.ghost_dilate,
            observed_enc=observed_enc,
        )
    fitness = terms.fitness + score_cfg.coverage_weight * terms.coverage
    return fitness, terms.coverage


def continuity_select(
    cand_poses: jax.Array,     # [C,4,4] fine-tier scored candidates
    cand_fitness: jax.Array,   # [C]
    prior_pose: jax.Array,     # [4,4] previous-frame / prior pose
    model_pts: jax.Array,      # [Nm,3] model cloud (subset is used)
    *,
    eps: float,
) -> jax.Array:
    """Continuity tie-break at the fine-tier selection
    (PsoConfig.tie_break_eps): among candidates within ``eps * |best|``
    of the top fitness, return the index of the one CLOSEST to the prior
    pose (mean point-to-point displacement of a model-cloud subset).

    Exact-symmetry twins (square-prism box: a 90° z-twin renders an
    IDENTICAL depth image) score equal up to per-frame sampling noise and
    otherwise hop frame to frame — metric-benign (sampled ADD-S floors at
    ~0.9 mm @ 8192 pts) but poison downstream: the hop injects a fake
    ~90° velocity into the motion prior and jumps any consumer of the
    pose stream. Near-ties WITHIN one basin differ by sub-mm, so the
    prior-consistent pick costs nothing; genuine basin competition is
    untouched (the measured flip-recovery margin is ~75% of fitness,
    README — far outside any tie window). C ~ 18 candidates x 128 points:
    negligible cost. Inputs are already all_gathered/replicated under
    sharding, so every shard agrees on the same pick.
    """
    sub = model_pts[: min(128, model_pts.shape[0])]
    pa = (jnp.einsum("cij,nj->cni", cand_poses[:, :3, :3], sub,
                     precision=jax.lax.Precision.HIGHEST)
          + cand_poses[:, None, :3, 3])
    pb = se3.transform_points(prior_pose, sub)
    d_prior = jnp.mean(jnp.linalg.norm(pa - pb[None], axis=-1), axis=-1)
    fmax = jnp.max(cand_fitness)
    elig = cand_fitness >= fmax - eps * jnp.abs(fmax)
    return jnp.argmin(jnp.where(elig, d_prior, jnp.inf))


def snap_to_branch(
    pose: jax.Array,         # [4,4] selected best pose
    prior_pose: jax.Array,   # [4,4] previous-frame / prior pose
    symmetries: jax.Array,   # [S,4,4] discrete symmetry group (incl. eye;
                             # identity-padded rows are harmless duplicates)
    model_pts: jax.Array,    # [Nm,3] model cloud (subset is used)
) -> jax.Array:
    """Snap `pose` to the symmetry branch closest to the prior:
    returns pose @ S*, S* = argmin_S mean point-to-point displacement of
    a model subset between pose @ S and the prior.

    For an EXACT model symmetry S, pose @ S renders an identical depth
    image — which branch the estimator reports is pure convention, and
    the fine-tier argmax picks whichever branch per-frame sampling noise
    favors (measured r5, square-prism box, clean tracking: raw frame
    rot error 32.6° mean from 90° twin hops while ADD-S read 1.2 mm).
    Snapping AFTER the pure-argmax selection keeps the argmax's
    drift-correcting behavior (a fitness-based continuity tie-break was
    measured WORSE — see PsoConfig.tie_break_eps) while making the
    reported pose stream temporally stable: no fake ~90° velocity in the
    motion prior, no branch jumps for downstream consumers. Zero
    accuracy cost by construction. S ~ 8 x 128 points: negligible."""
    # full-f32 contractions throughout (se3.py header: DEFAULT bf16
    # matmuls corrupt poses at millimeter scales)
    prec = jax.lax.Precision.HIGHEST
    cands = jnp.einsum("ij,sjk->sik", pose, symmetries, precision=prec)
    sub = model_pts[: min(128, model_pts.shape[0])]
    pa = (jnp.einsum("sij,nj->sni", cands[:, :3, :3], sub, precision=prec)
          + cands[:, None, :3, 3])
    pb = se3.transform_points(prior_pose, sub)
    d = jnp.mean(jnp.linalg.norm(pa - pb[None], axis=-1), axis=-1)  # [S]
    return cands[jnp.argmin(d)]


def pso(
    key: jax.Array,
    poses0: jax.Array,          # [P,4,4] initial swarm
    scene_pts: jax.Array,       # [Ns,3]
    scene_normals: jax.Array,   # [Ns,3]
    scene_weights: jax.Array,   # [Ns]
    model_pts: jax.Array,       # [Nm,3] ICP model cloud
    model_normals: jax.Array,   # [Nm,3]
    render_pts: jax.Array,      # [Nr,3] scoring surface samples
    render_normals: jax.Array,  # [Nr,3]
    render_w: jax.Array,        # [Nr]
    observed_depth: jax.Array,  # [h,w]
    observed_valid: jax.Array,  # [h,w]
    hand_depth: jax.Array,      # [h,w]
    *,
    fx: float, fy: float, cx: float, cy: float,
    height: int, width: int,
    splat_radius: int = 1,
    pso_cfg: PsoConfig = PsoConfig(),
    icp_cfg: IcpConfig = IcpConfig(),
    score_cfg: ScoreConfig = ScoreConfig(),
    axis_name: str | None = None,
    observed_neutral: jax.Array | None = None,  # [h,w] measured-but-
                       # excluded pixels (hand drop/speckle) — encoded as
                       # the no-evidence class, see score.encode_observed
    observed_hi: tuple | None = None,
    render_vis: jax.Array | None = None,  # [Nr] bool frame-constant render-
                       # sample visibility at the incumbent pose (second-
                       # order self-occlusion, estimator._search). Applied
                       # at EVERY tier of this frame — scan, explorer,
                       # polish, finisher — so fitness values stay
                       # comparable across the final selection.
    prior_pose: jax.Array | None = None,  # [4,4] tracked-mode prior for
                       # the continuity tie-break at the fine-tier
                       # selection (PsoConfig.tie_break_eps); None in
                       # pure-init callers
    prior_valid: jax.Array | None = None,  # traced bool: the prior is
                       # meaningful this frame (False on global re-init
                       # frames — the same compiled program serves both)
    explorer_seeds: jax.Array | None = None,  # [E,4,4] global-search seeds
                       # refined OUTSIDE the swarm (in-swarm explorers get
                       # recycled by the elite resample before they can
                       # converge): a dedicated batched mini-ICP + one
                       # scoring pass, best seed promoted into the
                       # fine-tier polish candidates — the per-frame
                       # wrong-basin recovery path
) -> PsoResult:
    """Annealed swarm search over SE(3) with in-loop batched ICP refine.

    Everything below is traced once: the scan carries ([P,4,4] poses,
    [P] fitness, best, sigma scale, rng key) through `pso_cfg.iters`
    iterations. All static shapes; safe under jit and shard_map: with
    `axis_name` set (parallel/sharding.py) this body runs per-shard on a
    slice of the swarm and the global best is agreed each iteration via
    one tiny all_gather — the replacement for the reference's
    single-threaded best tracking (SURVEY.md §3 comm table:
    "psum/all_gather for global-best selection across sharded particles").
    Returned best_* values are then replicated across shards; the elite
    resample stays shard-local (each shard teleports its own worst
    particles near the shared global best).
    """
    P = poses0.shape[0]
    n_resample = max(1, int(round(P * pso_cfg.elite_frac))) if P > 1 else 0

    # Two-tier scoring: the basin search (scan) scores against the
    # render-factor tier; the polish acceptance + finisher score against
    # `observed_hi` = (depth, valid, neutral, hand_depth, fx, fy, cx, cy,
    # h, w) at full resolution, whose silhouette evidence is pixel-sharp.
    # The coarse tier's gathers index a 16x smaller table (measurably
    # cheaper) and the scan does not need sub-mm discrimination.
    kr = min(pso_cfg.scan_render_subset, render_pts.shape[0])
    # encode the observed images ONCE per tier, outside the scans: the
    # silhouette-band dilation must not be recomputed every iteration
    enc_lo = score.encode_observed(
        observed_depth, observed_valid, score_cfg.ghost_dilate,
        neutral=observed_neutral,
    )
    # One-hot matmul gather tables (separable lookups, ops/gather_mxu):
    # split the encoded-observed and hand images into double-bf16 pairs
    # ONCE per tier, outside the scans. Hand +inf (no hand there) must
    # become a large finite sentinel before splitting: split_bf16(inf)
    # would produce inf - inf = NaN (jax_debug_nans CI guard).
    use_mxu = score_cfg.gather_mode == "mxu" and score_cfg.mode == "point"
    if use_mxu:
        from . import gather_mxu

        def hand_tables(hd):
            sent = jnp.where(jnp.isfinite(hd), hd, score._FAR)
            return gather_mxu.split_bf16(sent)

        mxu_lo = ("image", *gather_mxu.split_bf16(enc_lo),
                  *hand_tables(hand_depth))
    else:
        mxu_lo = None
    score_fn = partial(
        score_particles,
        render_pts=render_pts[:kr], render_normals=render_normals[:kr],
        render_w=render_w[:kr],
        observed_depth=observed_depth, observed_valid=observed_valid,
        hand_depth=hand_depth,
        fx=fx, fy=fy, cx=cx, cy=cy, height=height, width=width,
        splat_radius=splat_radius, score_cfg=score_cfg,
        observed_enc=enc_lo,
        mxu_tables=mxu_lo,
        sample_mask=None if render_vis is None else render_vis[:kr],
    )
    if observed_hi is not None:
        (d_hi, v_hi, n_hi, h_hi,
         fx_h, fy_h, cx_h, cy_h, hh, wh) = observed_hi
        enc_hi = score.encode_observed(
            d_hi, v_hi, score_cfg.ghost_dilate, neutral=n_hi)
        # fine tier discriminates millimeters: its own (smaller)
        # saturation scale — at the coarse tau a mm-wrong pose still
        # collects near-full support and the finisher cannot rank it
        score_cfg_hi = (
            dataclasses.replace(score_cfg, depth_tau=score_cfg.depth_tau_fine)
            if score_cfg.depth_tau_fine > 0 else score_cfg
        )
        score_fn_hi = partial(
            score_particles,
            render_pts=render_pts, render_normals=render_normals,
            render_w=render_w,
            observed_depth=d_hi, observed_valid=v_hi, hand_depth=h_hi,
            fx=fx_h, fy=fy_h, cx=cx_h, cy=cy_h, height=hh, width=wh,
            splat_radius=splat_radius, score_cfg=score_cfg_hi,
            # fine tier: sub-pixel (edge-aware bilinear) observed-depth
            # gather removes the ~z/f-per-pixel quantization floor
            subpixel=score_cfg.subpixel,
            observed_enc=enc_hi,
            sample_mask=render_vis,
        )
    else:
        score_fn_hi = score_fn
        score_cfg_hi = score_cfg

    # Stochastic inner ICP (cf. SGD-ICP, PAPERS.md): the in-loop refine
    # pulls each particle toward the local basin — it does not need every
    # correspondence, so it runs on fixed-size subsets (both clouds are
    # already randomly ordered from sampling), cutting the dominant
    # [P,Ns,Nm] correspondence cost ~8-16x. The final polish below uses
    # the full clouds.
    ks = min(pso_cfg.icp_scene_subset, scene_pts.shape[0])
    km = min(pso_cfg.icp_model_subset, model_pts.shape[0])

    # Observation-side scene-coverage term (ScoreConfig.scene_cov_weight):
    # fitness += w * (explained - 1), explained = weighted fraction of
    # scene points within scene_cov_tau of the posed model surface.
    # Projective render-and-compare only scores MODEL samples against the
    # image — it never pays for observed points the pose fails to explain,
    # so a pose covering half the cloud while hiding the rest of itself
    # behind the hand-dropped region can out-score truth (measured r3:
    # box slid 48 mm -> fitness 1.455 vs truth-basin 1.335, and tracking
    # seeded AT truth migrated into the slide). The term is ~0 near truth
    # (explained ~0.99) and strongly negative for such slides (0.57), so
    # fitness scales stay intact. In the scan it is a FREE byproduct of
    # the inner-ICP correspondence search (scene -> posed-model NN).
    cov_w = float(score_cfg.scene_cov_weight)
    cov_tau = float(score_cfg.scene_cov_tau)
    use_cov = cov_w > 0.0

    def refine(poses):
        refined, st = icp_mod.icp_batched(
            poses, scene_pts[:ks], scene_normals[:ks], scene_weights[:ks],
            model_pts[:km], model_normals[:km],
            iters=pso_cfg.icp_iters_inner,
            max_corresp_dist=icp_cfg.max_corresp_dist,
            normal_angle_max_deg=icp_cfg.normal_angle_max_deg,
            damping=icp_cfg.damping,
            step_scale=icp_cfg.step_scale,
            gn_reps=icp_cfg.gn_reps,
            support_tau=cov_tau if use_cov else 0.0,
        )
        return refined, st.support

    def sub_support(poses):
        """Explicit support on the inner-ICP subsets (same tier as the
        refine byproduct), for poses that did not just run refine."""
        return icp_mod.scene_support(
            poses, scene_pts[:ks], scene_weights[:ks], model_pts[:km],
            tau=cov_tau,
        )

    def swarm_best(poses, fitness, coverage):
        """Shard-local argmax, then (if sharded) a cross-shard agreement
        round: all_gather the per-shard champions ([n_shards,4,4] poses +
        [n_shards] scalars — bytes, not clouds) and argmax once more."""
        bi = jnp.argmax(fitness)
        bp, bf, bc = poses[bi], fitness[bi], coverage[bi]
        if axis_name is not None:
            bps = jax.lax.all_gather(bp, axis_name)
            bfs = jax.lax.all_gather(bf, axis_name)
            bcs = jax.lax.all_gather(bc, axis_name)
            gi = jnp.argmax(bfs)
            bp, bf, bc = bps[gi], bfs[gi], bcs[gi]
        return bp, bf, bc

    fitness0, coverage0 = score_fn(poses0)
    if use_cov:
        supp0 = sub_support(poses0)
        fitness0 = fitness0 + cov_w * (supp0 - 1.0)
    else:
        supp0 = jnp.zeros((P,), poses0.dtype)
    bp0, bf0, bc0 = swarm_best(poses0, fitness0, coverage0)
    init = (
        poses0, fitness0, supp0,
        bp0, bf0, bc0,
        jnp.asarray(1.0, poses0.dtype), key,
    )

    def body(carry, it):
        poses, fitness, supp, best_pose, best_fit, best_cov, sig, k = carry
        k, k_pert, k_res = jax.random.split(k, 3)

        # 1. perturb: annealed SE(3) noise about each particle's own pose;
        #    particle 0 is pinned to the incumbent best (elitism) so the
        #    best-ever hypothesis is always re-evaluated, never lost.
        #    One batched noise draw, not P split keys + vmap.
        perturbed = se3.perturb_pose(
            k_pert, poses, pso_cfg.rot_sigma * sig, pso_cfg.trans_sigma * sig,
            shape=(P,),
        )
        poses = perturbed.at[0].set(best_pose)

        # 2. ICP refine (data-driven local pull), every icp_every iters.
        #    The support byproduct rides along; on skipped iterations it
        #    is carried stale (poses moved only by the anneal-scale
        #    perturbation — a basin-scale term tolerates that).
        if pso_cfg.icp_every > 0:
            poses, supp = jax.lax.cond(
                it % pso_cfg.icp_every == 0,
                lambda ps: refine(ps[0]),
                lambda ps: ps,
                (poses, supp),
            )
        elif use_cov:
            supp = sub_support(poses)

        # 3. render-and-compare fitness for the whole swarm.
        fitness, coverage = score_fn(poses)
        if use_cov:
            fitness = fitness + cov_w * (supp - 1.0)

        # 4. global best update (cross-shard when axis_name is set).
        bp, bf, bc = swarm_best(poses, fitness, coverage)
        improved = bf > best_fit
        best_pose = jnp.where(improved, bp, best_pose)
        best_fit = jnp.where(improved, bf, best_fit)
        best_cov = jnp.where(improved, bc, best_cov)

        # 5. elite resample: the worst n_resample particles teleport to
        #    fresh perturbations of the global best. top_k on negated
        #    fitness beats a full argsort in the scan body. Gated on
        #    it >= resample_after: global init needs an exploration phase
        #    before exploitation may collapse diversity onto one basin.
        if n_resample > 0:
            _, worst = jax.lax.top_k(-fitness, n_resample)
            fresh = se3.perturb_pose(
                k_res, best_pose,
                pso_cfg.rot_sigma * sig, pso_cfg.trans_sigma * sig,
                shape=(n_resample,),
            )
            do = it >= pso_cfg.resample_after
            poses = poses.at[worst].set(
                jnp.where(do, fresh, poses[worst])
            )
            fitness = fitness.at[worst].set(
                jnp.where(do, -jnp.inf, fitness[worst])
            )

        sig = sig * pso_cfg.sigma_decay
        return (poses, fitness, supp, best_pose, best_fit, best_cov,
                sig, k), best_fit

    (poses, fitness, _, best_pose, best_fit, best_cov, _, k_end), trace = (
        jax.lax.scan(body, init, jnp.arange(pso_cfg.iters))
    )

    # Final polish at the FINE scoring tier, over the top-K swarm
    # candidates (not only the incumbent): competing basins can sit
    # within a few percent of each other at the coarse tier (quantized,
    # subset-sampled), so basin selection is deferred to here. Each
    # candidate is full-ICP-polished (batched — K+1 poses cost ~K/P of
    # one in-scan refine) and both raw and polished versions are scored
    # hi-res; per candidate the polished pose wins within a small
    # tolerance (geometric refinement is trusted over the tau-saturated
    # score surrogate), then the best candidate wins outright.
    K = max(0, min(pso_cfg.polish_top_k, P - 1))
    if K > 0:
        _, topi = jax.lax.top_k(fitness, K)
        cands = jnp.concatenate([best_pose[None], poses[topi]])  # [K+1,4,4]
    else:
        cands = best_pose[None]
    if explorer_seeds is not None:
        refined_seeds, supp_exp = refine(explorer_seeds)  # subset batched ICP
        for _ in range(2):                      # a few extra pulls: seeds
            refined_seeds, supp_exp = refine(refined_seeds)  # start far out
        f_exp, _ = score_fn(refined_seeds)
        if use_cov:
            f_exp = f_exp + cov_w * (supp_exp - 1.0)
        e_best = jnp.argmax(f_exp)
        cands = jnp.concatenate([cands, refined_seeds[e_best][None]])
    n_slide = pso_cfg.slide_proposals
    if n_slide > 1:
        # Axial-slide proposals (see PsoConfig.slide_proposals): probe the
        # competing translational basins along the model's principal axis
        # directly from the incumbent. The axis is a per-object constant
        # but cheap enough to derive in-program (3x3 eigh). Full-f32
        # products: a TF32 scatter matrix tilts the axis by ~1e-3 rad.
        prec = jax.lax.Precision.HIGHEST
        mc = jnp.mean(model_pts, axis=0)
        Xc = model_pts - mc
        _, evecs = jnp.linalg.eigh(jnp.matmul(Xc.T, Xc, precision=prec))
        ax = evecs[:, -1]                                  # model frame
        proj = jnp.matmul(Xc, ax, precision=prec)
        extent = jnp.max(proj) - jnp.min(proj)
        half = n_slide // 2
        fr = (jnp.arange(1, half + 1, dtype=poses0.dtype) / half
              * pso_cfg.slide_max_frac)
        offs = jnp.concatenate([fr, -fr]) * extent         # [2*half]
        d_cam = jnp.matmul(best_pose[:3, :3], ax, precision=prec)
        slid = jnp.tile(best_pose[None], (offs.shape[0], 1, 1))
        slid = slid.at[:, :3, 3].add(offs[:, None] * d_cam[None])
        cands = jnp.concatenate([cands, slid])
    polished, pol_stats = icp_mod.icp_batched(
        cands, scene_pts, scene_normals, scene_weights,
        model_pts, model_normals,
        iters=icp_cfg.iters,
        max_corresp_dist=icp_cfg.max_corresp_dist,
        normal_angle_max_deg=icp_cfg.normal_angle_max_deg,
        damping=icp_cfg.damping,
        step_scale=icp_cfg.step_scale,
        gn_reps=icp_cfg.gn_reps,
        support_tau=cov_tau if use_cov else 0.0,
    )
    f_c, c_c = score_fn_hi(cands)
    f_p, c_p = score_fn_hi(polished)
    if use_cov:
        # fine-tier support on the FULL clouds (same arrays the polish
        # searched; the raw candidates need one explicit search)
        supp_c = icp_mod.scene_support(
            cands, scene_pts, scene_weights, model_pts, tau=cov_tau,
        )
        f_c = f_c + cov_w * (supp_c - 1.0)
        f_p = f_p + cov_w * (pol_stats.support - 1.0)
    take_pol = f_p >= f_c - pso_cfg.polish_accept_tol
    f_sel = jnp.where(take_pol, f_p, f_c)
    c_sel = jnp.where(take_pol, c_p, c_c)
    p_sel = jnp.where(take_pol[:, None, None], polished, cands)
    if use_cov:
        s_sel = jnp.where(take_pol, pol_stats.support, supp_c)
    else:
        s_sel = jnp.zeros_like(f_sel)
    if axis_name is not None:
        # gather every shard's candidate set so the selection below (and
        # the multi-hypothesis extraction downstream) sees all basins
        p_sel = jax.lax.all_gather(p_sel, axis_name).reshape(-1, 4, 4)
        f_sel = jax.lax.all_gather(f_sel, axis_name).reshape(-1)
        c_sel = jax.lax.all_gather(c_sel, axis_name).reshape(-1)
        s_sel = jax.lax.all_gather(s_sel, axis_name).reshape(-1)
    bi = jnp.argmax(f_sel)
    if prior_pose is not None and pso_cfg.tie_break_eps > 0:
        bi_tie = continuity_select(
            p_sel, f_sel, prior_pose, model_pts,
            eps=pso_cfg.tie_break_eps,
        )
        if prior_valid is not None:
            bi = jnp.where(prior_valid, bi_tie, bi)
        else:
            bi = bi_tie
    best_pose, best_fit, best_cov = p_sel[bi], f_sel[bi], c_sel[bi]
    # the finisher perturbs by millimeters: its support is frozen at the
    # selected basin's value (term0), keeping its fitness comparable to
    # best_fit without a per-iteration NN search
    term0 = cov_w * (s_sel[bi] - 1.0) if use_cov else 0.0

    # Score-only annealed finisher: ICP cannot constrain the tangential
    # DOFs of near-flat geometry (any in-face slide is a point-to-plane
    # fixed point), and the in-loop stochastic ICP re-slides particles
    # before they are scored, so the swarm search alone stalls ~3-4 mm
    # from the (sharp, correctly-peaked) fitness optimum. This stage
    # climbs the score directly: the whole swarm re-samples tightly
    # around the incumbent best with millimeter sigmas, no ICP. Monotone
    # in best_fit by construction. Under sharding the perturbation keys
    # are shard-unique (an effective Pf * n_shards finisher swarm) but
    # the result stays bitwise-replicated: swarm_best all_gathers the
    # per-shard champions every iteration, so every shard applies the
    # same argmax (pinned by test_sharded_outputs_bitwise_replicated).
    if pso_cfg.finish_iters > 0:
        fs0 = pso_cfg.finish_sigma_frac
        # clamp to 4x the (per-shard) swarm: the finisher batch is
        # independent of the swarm, but tiny test swarms should not pay
        # a production-size finisher (production: P=512 -> uncapped)
        Pf = max(2, min(pso_cfg.finish_particles, 4 * P))

        score_fn_fin = score_fn_hi
        if use_mxu and observed_hi is not None:
            # Per-point patch tables (gather_mxu.take_patch_corners):
            # the finisher perturbs by millimeters around best_pose, so
            # each render sample's projection stays within a few px of
            # its reference projection for the whole finisher — extract
            # one [Nr,S,S] patch pair per table around the REFERENCE
            # projections and every in-scan lookup becomes a [*,S]@[S,S]
            # one-hot matmul.
            S = pso_cfg.finish_patch
            ref = se3.transform_points(best_pose, render_pts)    # [Nr,3]
            zr = jnp.maximum(ref[..., 2], 1e-6)
            ur = jnp.round(ref[..., 0] / zr * fx_h + cx_h).astype(jnp.int32)
            vr = jnp.round(ref[..., 1] / zr * fy_h + cy_h).astype(jnp.int32)
            pu0 = jnp.clip(ur - S // 2, 0, wh - S)
            pv0 = jnp.clip(vr - S // 2, 0, hh - S)
            # slice the two f32 images once, split the (tiny) patches
            # after: 2 vmapped dynamic_slice passes instead of 4
            h_sent = jnp.where(jnp.isfinite(h_hi), h_hi, score._FAR)
            enc_p = gather_mxu.extract_patches(enc_hi, pv0, pu0, S)
            hand_p = gather_mxu.extract_patches(h_sent, pv0, pu0, S)
            mxu_fin = ("patch", *gather_mxu.split_bf16(enc_p),
                       *gather_mxu.split_bf16(hand_p), pv0, pu0)
            score_fn_fin = partial(
                score_particles,
                render_pts=render_pts, render_normals=render_normals,
                render_w=render_w,
                observed_depth=d_hi, observed_valid=v_hi, hand_depth=h_hi,
                fx=fx_h, fy=fy_h, cx=cx_h, cy=cy_h, height=hh, width=wh,
                splat_radius=splat_radius, score_cfg=score_cfg_hi,
                subpixel=score_cfg.subpixel,
                observed_enc=enc_hi,
                mxu_tables=mxu_fin,
                sample_mask=render_vis,
            )
        # Sigma LADDER: each iteration's batch spans finish_sigma_rungs
        # anneal scales simultaneously (particle i at sigma_decay^(i%R)),
        # instead of one scale per iteration. The frame program is
        # latency-bound, not FLOP-bound, so the same number of fine-tier
        # score evaluations costs less wall time as 4 large sequential
        # ops than as 12 small ones — and the finest rung is present
        # from iteration 1. Per-iteration
        # sig decays by sigma_decay^finish_sigma_rungs so the schedule
        # still reaches the same finest scale overall.
        R = max(1, pso_cfg.finish_sigma_rungs)
        ladder = jnp.power(
            jnp.asarray(pso_cfg.sigma_decay, poses0.dtype),
            jnp.arange(Pf, dtype=poses0.dtype) % R,
        )[:, None]
        iter_decay = pso_cfg.sigma_decay ** R

        def fbody(carry, _):
            best_pose, best_fit, best_cov, sig, k = carry
            k, kp = jax.random.split(k)
            cand = se3.perturb_pose(
                kp, best_pose,
                pso_cfg.rot_sigma * fs0 * sig * ladder,
                pso_cfg.trans_sigma * fs0 * sig * ladder,
                shape=(Pf,),
            )
            cand = cand.at[0].set(best_pose)
            f, c = score_fn_fin(cand)
            f = f + term0
            bp, bf, bc = swarm_best(cand, f, c)
            improved = bf > best_fit
            best_pose = jnp.where(improved, bp, best_pose)
            best_fit = jnp.where(improved, bf, best_fit)
            best_cov = jnp.where(improved, bc, best_cov)
            return (best_pose, best_fit, best_cov,
                    sig * iter_decay, k), None

        (best_pose, best_fit, best_cov, _, _), _ = jax.lax.scan(
            fbody,
            (best_pose, best_fit, best_cov, jnp.asarray(1.0, poses0.dtype),
             k_end),
            None, length=pso_cfg.finish_iters,
        )

    return PsoResult(
        best_pose=best_pose, best_fitness=best_fit, best_coverage=best_cov,
        poses=poses, fitness=fitness, fitness_trace=trace,
        cand_poses=p_sel, cand_fitness=f_sel, cand_coverage=c_sel,
    )


def diverse_hypotheses(
    cand_poses: jax.Array,     # [C,4,4] fine-tier scored candidates
    cand_fitness: jax.Array,   # [C]
    n: int,
    *,
    first_pose: jax.Array | None = None,   # [4,4] forced hypothesis 0
    first_fitness: jax.Array | None = None,
    rot_min_deg: float = 15.0,
    trans_min: float = 0.02,
) -> tuple[jax.Array, jax.Array]:
    """Greedy farthest-basin selection: n hypotheses from the candidate
    set, each at least (rot_min_deg OR trans_min) from all earlier picks.

    Multi-hypothesis tracking (Tracker n_hypotheses>1) carries the best
    pose of each COMPETING basin across frames, so an ambiguity resolved
    by later evidence (motion exposing an occluded feature) flips to the
    right basin instantly instead of re-discovering it. When fewer than n
    distinct basins exist, the remaining slots return fitness -inf (the
    tracker seeds them from hypothesis 0).
    """
    sel_p, sel_f = [], []
    avail = cand_fitness
    if first_pose is not None:
        sel_p.append(first_pose)
        sel_f.append(first_fitness if first_fitness is not None
                     else cand_fitness.max())
        near = _near_pose(cand_poses, first_pose, rot_min_deg, trans_min)
        avail = jnp.where(near, -jnp.inf, avail)
    while len(sel_p) < n:
        i = jnp.argmax(avail)
        ok = jnp.isfinite(avail[i])
        p = cand_poses[i]
        sel_p.append(p)
        sel_f.append(jnp.where(ok, avail[i], -jnp.inf))
        near = _near_pose(cand_poses, p, rot_min_deg, trans_min)
        avail = jnp.where(near, -jnp.inf, avail)
    return jnp.stack(sel_p), jnp.stack(sel_f)


def _near_pose(poses, pose, rot_min_deg, trans_min):
    """[C] bool: within BOTH rotation and translation radii of `pose`."""
    # full f32: near cos = 1 a TF32 trace loses whole degrees
    cos = (jnp.einsum("cij,ij->c", poses[:, :3, :3], pose[:3, :3],
                      precision=jax.lax.Precision.HIGHEST) - 1.0) / 2.0
    rot_deg = jnp.degrees(jnp.arccos(jnp.clip(cos, -1.0, 1.0)))
    tr = jnp.linalg.norm(poses[:, :3, 3] - pose[:3, 3], axis=-1)
    return (rot_deg < rot_min_deg) & (tr < trans_min)
