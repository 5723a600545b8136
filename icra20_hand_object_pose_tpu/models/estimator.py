"""Per-frame pose estimator and sequence tracker.

Rebuild of the reference's PoseEstimator + main-loop driver
(SURVEY.md §4.1-§4.4). The entire per-frame pipeline — hand FK +
segmentation, fused depth preprocessing, swarm init, the full PSO loop
with in-loop batched ICP, render-and-compare scoring with finger
occlusion masks, global-best selection — is ONE jit-compiled device
program (`_frame_step`): one host->device crossing per frame versus the
reference's O(particles * iterations) GL dispatches (SURVEY.md §4.2).

Public API mirrors the reference's surface (BASELINE north star: "load
object mesh + hand model -> feed depth frames -> SE(3) pose per frame"):

    est = Estimator(ObjectModel.load("obj.ply"), make_t42_hand(), cfg)
    tracker = Tracker(est)
    for depth in frames:
        out = tracker.step(depth, hand_base_pose, hand_q)
        out.pose  # [4,4] model->camera
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import icp as icp_ops
from ..ops import knn, preprocess, pso, render
from ..ops import score as score_ops
from ..utils import se3
from ..utils.config import EstimatorConfig
from .hand import HandModel
from .object_model import ObjectModel


def _ckpt_path(path: str) -> str:
    """np.savez silently appends .npz when missing; mirror that on load so
    save('ckpt') / load('ckpt') round-trips (ADVICE r1)."""
    return path if path.endswith(".npz") else path + ".npz"


class FrameResult(NamedTuple):
    pose: jax.Array           # [4,4] model->camera
    fitness: jax.Array        # scalar, higher better
    coverage: jax.Array       # scalar in [0,1]
    fitness_trace: jax.Array  # [pso_iters]
    n_scene: jax.Array        # scalar, surviving scene points
    hyp_poses: jax.Array      # [H,4,4] competing-basin hypotheses (0 = best)
    hyp_fitness: jax.Array    # [H] (-inf = slot without a distinct basin)
    hand_delta: jax.Array | None = None  # [4,4] auto-armed hand-base
                              # correction (meaningful from the init
                              # program only; exact identity when the
                              # margin-accept rejects or on track/no-hand
                              # programs — constant pytree structure
                              # keeps one sweep out_shardings spec valid
                              # for both programs). A mount extrinsic
                              # error is constant over a sequence, so the
                              # Tracker composes this into TrackerState.
                              # hand_delta and pre-multiplies every later
                              # reported base.


class Estimator:
    """One object + one hand + one camera, compiled once per swarm size."""

    def __init__(
        self,
        obj: ObjectModel,
        hand: HandModel | None,
        cfg: EstimatorConfig = EstimatorConfig(),
        mesh: jax.sharding.Mesh | None = None,
        axis_name: str = "p",
    ):
        self.obj = obj
        self.hand = hand if (hand is not None and cfg.hand.enabled) else None
        self.cfg = cfg
        # Optional device mesh: the swarm's particle axis is sharded over
        # `axis_name`; frame inputs are replicated, the per-iteration
        # global-best agreement is a tiny all_gather
        # (SURVEY.md §3 parallelism table — DP over particles).
        self.mesh = mesh
        self.axis_name = axis_name
        cam = cfg.camera
        # low-res raster grid for render-and-compare (integer min-pool factor)
        self.render_factor = max(1, cam.height // cfg.render_size)
        self.lo_h = cam.height // self.render_factor
        self.lo_w = cam.width // self.render_factor
        self.lo_fx = cam.fx / self.render_factor
        self.lo_fy = cam.fy / self.render_factor
        self.lo_cx = cam.cx / self.render_factor
        self.lo_cy = cam.cy / self.render_factor
        # one jit per (n_particles,) — track and init modes compile separately
        statics = ("n_particles", "pso_iters", "resample_after", "prescreen",
                   "init_scoring")
        if self.mesh is None:
            self._step_jit = jax.jit(self._frame_step, static_argnames=statics)
        else:
            self._step_jit = jax.jit(self._sharded_step, static_argnames=statics)
        # per-mode constant device arrays for frame_args: every eager
        # jnp.asarray is a separate host->device transfer, so the 4
        # sigma/flag scalars and the default hand tensors are
        # materialized once, not per frame
        self._mode_consts: dict = {}
        self._hand_defaults: tuple | None = None

    def _sharded_step(self, *args, n_particles: int, pso_iters: int,
                      resample_after: int = 0, prescreen: int = 0,
                      init_scoring: bool = False):
        """shard_map the whole frame program: inputs replicated, the swarm
        generated shard-locally (axis_index-folded RNG) so only tiny
        global-best all_gathers cross devices. Outputs are replicated."""
        from jax.sharding import PartitionSpec as P
        from jax import shard_map
        import functools

        n_dev = self.mesh.size
        if n_particles % n_dev:
            raise ValueError(
                f"n_particles={n_particles} not divisible by mesh size {n_dev}"
            )
        fn = functools.partial(
            self._frame_step,
            n_particles=n_particles // n_dev,
            pso_iters=pso_iters,
            resample_after=resample_after,
            prescreen=prescreen,
            init_scoring=init_scoring,
        )
        sm = shard_map(
            fn, mesh=self.mesh,
            in_specs=(P(),) * 10, out_specs=P(), check_vma=False,
        )
        return sm(*args)

    # -- traced frame program ------------------------------------------------

    def _hand_tensors(self, key, hand_base, hand_q, depth_m,
                      init_scoring: bool = False):
        """Sampled hand clouds -> (full-res drop mask, low-res occluder depth,
        flat hand cloud for point-level segmentation).

        With hand.config_select > 0 the K sampled finger configs are
        scored against the observed depth (render-space agreement,
        models/hand.config_agreement) and only the best-agreeing subset
        builds the masks — the blind union of all K over-drops object
        evidence whenever the nominal q is wrong (underactuated hand,
        no encoders; SURVEY.md §1). Scoring runs on the low-res grid
        when render_factor > 1 (K extra splats at full VGA would cost
        tens of ms; min-pool downsampling keeps the same foreground
        min-z bias direction as the splats, so the comparison stays
        bias-matched)."""
        cfg = self.cfg
        cam = cfg.camera
        n_sel = cfg.hand.config_select
        auto_refine = (
            init_scoring
            and cfg.hand.base_refine_iters == 0
            and cfg.hand.base_refine_auto
        )
        hand_delta = None  # set only by the auto-arm path below
        need_lo = cfg.hand.base_refine_iters > 0 or auto_refine or (
            0 < n_sel < cfg.hand.config_samples
        )
        if need_lo:
            # the render-space agreement grid: observed depth on the same
            # min-pooled low-res lattice the scorer uses (bias-matched to
            # the candidate splats; see config_agreement docstring)
            dvalid = (depth_m > cfg.depth_min) & (depth_m < cfg.depth_max)
            if self.render_factor == 1:
                d_lo_h, v_lo_h = depth_m, dvalid
            else:
                d_lo_h, v_lo_h = preprocess.downsample_depth(
                    depth_m, dvalid, self.render_factor
                )
        if cfg.hand.base_refine_iters > 0 or auto_refine:
            # hand-mount calibration correction: fit the reported base to
            # the observed depth before ANY mask is built — the sampled
            # joint configs below all inherit the base, so a wrong base
            # corrupts every mask identically (models/hand.refine_base)
            key, k_base = jax.random.split(key)

            def _refine(hb):
                return self.hand.refine_base(
                    k_base, d_lo_h, v_lo_h, hb, hand_q,
                    fx=self.lo_fx, fy=self.lo_fy,
                    cx=self.lo_cx, cy=self.lo_cy,
                    height=self.lo_h, width=self.lo_w,
                    iters=cfg.hand.base_refine_iters or 3,
                    candidates=cfg.hand.base_refine_candidates,
                    rot_sigma=cfg.hand.base_refine_rot_sigma,
                    trans_sigma=cfg.hand.base_refine_trans_sigma,
                    q_sigma=cfg.hand.joint_sigma,
                )

            if auto_refine:
                # AUTO-ARM (VERDICT r4 item 5), init program only: run
                # the search, but ACCEPT its winner only when the
                # winner's observed-depth agreement beats the reported
                # base's by base_refine_accept_margin. An absolute
                # agreement threshold cannot tell the regimes apart
                # (measured r5: calibrated scores -0.05..0.25 overlap
                # miscalibrated -0.20..0.24 — the level is scene-
                # dominated), but the GAIN can: an exactly-calibrated
                # base only ever gains the score-space splat-floor
                # overfit (<= +0.059 over 6 draws) while a genuinely
                # miscalibrated one gains +0.084..+0.273 — see
                # HandConfig.base_refine_auto and
                # scripts/calibrate_base_agree.py.
                def _agree(hb):
                    return self.hand.config_agreement(
                        self.hand.cloud(hb, hand_q)[None],
                        d_lo_h, v_lo_h,
                        fx=self.lo_fx, fy=self.lo_fy,
                        cx=self.lo_cx, cy=self.lo_cy,
                        height=self.lo_h, width=self.lo_w,
                    )[0]

                refined = _refine(hand_base)
                gain = _agree(refined) - _agree(hand_base)
                accept = gain > cfg.hand.base_refine_accept_margin
                # delta = accepted correction RELATIVE to the base this
                # program was fed. A mount-calibration error is CONSTANT
                # over a sequence, so the Tracker carries this delta and
                # pre-multiplies every subsequent reported base with it —
                # tracked frames get corrected masks WITHOUT re-running
                # the search (the r5 realistic_heavy failure mode: a
                # default-config tracker fed a 3 deg/5 mm-off base locked
                # a 66 mm basin because only the init program refined).
                # Exact identity when rejected (not refined @ inv(base):
                # float round-off would otherwise compound in the
                # Tracker's composition across re-inits).
                hand_delta = jnp.where(
                    accept,
                    se3.compose(refined, se3.inverse(hand_base)),
                    jnp.eye(4, dtype=hand_base.dtype),
                )
                hand_base = jnp.where(accept, refined, hand_base)
            else:
                hand_base = _refine(hand_base)
        clouds = self.hand.sampled_clouds(
            key, hand_base, hand_q, cfg.hand.joint_sigma, cfg.hand.config_samples
        )                                             # [K,Nh,3]
        if 0 < n_sel < clouds.shape[0]:
            agree = self.hand.config_agreement(
                clouds, d_lo_h, v_lo_h,
                fx=self.lo_fx, fy=self.lo_fy,
                cx=self.lo_cx, cy=self.lo_cy,
                height=self.lo_h, width=self.lo_w,
            )
            _, top = jax.lax.top_k(agree, n_sel)
            clouds = clouds[top]
        flat = clouds.reshape(-1, 3)
        w = jnp.ones(flat.shape[0], flat.dtype)
        if self.render_factor == 1:
            # one VGA splat serves both roles (no second full-res
            # scatter)
            hd_full = render.splat_depth(
                flat, w, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                height=cam.height, width=cam.width, radius=2,
            )
            hd_lo = hd_full
        else:
            # Low-res conservative occluder depth for render-and-compare.
            hd_lo = render.splat_depth(
                flat, w, fx=self.lo_fx, fy=self.lo_fy,
                cx=self.lo_cx, cy=self.lo_cy,
                height=self.lo_h, width=self.lo_w, radius=1,
            )
            if cfg.hand.full_res_mask:
                # Full-res hand depth: classifies pixels (hand itself, or
                # behind a finger -> unreliable) for preprocessing drop.
                hd_full = render.splat_depth(
                    flat, w, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                    height=cam.height, width=cam.width, radius=2,
                )
            else:
                # nearest-upsample the lo splat: the min-pooled lo grid is
                # conservative toward the camera, so the drop band only
                # WIDENS (never leaks hand pixels into the scene); the
                # exact point-level removal below stays full-precision
                f = self.render_factor
                up = jnp.repeat(jnp.repeat(hd_lo, f, axis=0), f, axis=1)
                hd_full = up[: cam.height, : cam.width]
                pad_h = cam.height - hd_full.shape[0]
                pad_w = cam.width - hd_full.shape[1]
                if pad_h or pad_w:
                    hd_full = jnp.pad(
                        hd_full, ((0, pad_h), (0, pad_w)),
                        constant_values=jnp.inf,
                    )
        return hd_full, hd_lo, flat, hand_delta

    def _scene_prep(
        self,
        k_hand: jax.Array,
        k_pre: jax.Array,
        depth_m: jax.Array,       # [H,W] meters
        hand_base: jax.Array,     # [4,4]
        hand_q: jax.Array,        # [J]
        init_scoring: bool = False,
    ) -> tuple:
        """Object-INDEPENDENT per-frame work: hand masks, fused depth
        preprocessing, point-level hand removal. Split out of _frame_step
        so LibrarySweep(shared_scene=True) computes it ONCE per frame and
        broadcasts it across the vmapped per-object search — the
        reference's model-library use case is one observed frame scored
        against many candidate models, so the O-fold replication of this
        block is pure waste there. Returns (scene, weights, hd_lo, hd_hi,
        hand_delta) — hand_delta is the auto-armed base correction
        ([4,4], None outside the auto-refine init path) the Tracker
        carries forward across the sequence."""
        cfg = self.cfg
        cam = cfg.camera
        hand_delta = None
        # 1. hand: FK under actuation uncertainty -> masks (SURVEY.md §2 L3).
        if self.hand is not None:
            hd_full, hd_lo, hand_flat, hand_delta = self._hand_tensors(
                k_hand, hand_base, hand_q, depth_m, init_scoring
            )
            seg = cfg.hand.segment_dist
            # drop pixels on or behind the rendered hand
            extra_invalid = jnp.isfinite(hd_full) & (depth_m > hd_full - seg)
            hd_hi = hd_full
        else:
            hd_lo = jnp.full((self.lo_h, self.lo_w), jnp.inf, depth_m.dtype)
            hd_hi = jnp.full(depth_m.shape, jnp.inf, depth_m.dtype)
            hand_flat = None
            extra_invalid = None

        # 2. fused preprocessing: backproject + normals + subsample (L2).
        scene = preprocess.preprocess_frame(
            k_pre, depth_m,
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
            depth_min=cfg.depth_min, depth_max=cfg.depth_max,
            n_points=cfg.scene_points, render_factor=self.render_factor,
            extra_invalid=extra_invalid,
            outlier_tau=cfg.outlier_tau,
            outlier_min_neighbors=cfg.outlier_min_neighbors,
        )
        weights = scene.weights
        # exact point-level hand removal on the subsampled cloud (fused
        # distance + min, SURVEY.md §3 "Hand segmentation")
        if hand_flat is not None:
            d2h = knn.pairwise_sqdist(scene.points, hand_flat)
            is_hand = jnp.min(d2h, axis=-1) < cfg.hand.segment_dist**2
            weights = weights * (~is_hand)
        return scene, weights, hd_lo, hd_hi, hand_delta

    def _search(
        self,
        k_init: jax.Array,
        k_pso: jax.Array,
        prep: tuple,              # _scene_prep output
        prev_pose: jax.Array,     # [4,4], or [Hy,4,4] hypothesis priors
        obj_tensors: tuple,       # (model_pts, model_normals,
                                  #  render_pts, render_normals, render_w,
                                  #  symmetries [S,4,4])
        rot_sigma: jax.Array,
        trans_sigma: jax.Array,
        uniform_rot: jax.Array,
        roi_radius: jax.Array,
        *,
        n_particles: int,
        pso_iters: int,
        resample_after: int = 0,
        prescreen: int = 0,
        init_scoring: bool = False,
    ) -> FrameResult:
        """Per-OBJECT swarm search over a prepared scene: ROI crop, swarm
        init (+orientation prescreen), the PSO+ICP+render-and-compare
        loop, and hypothesis extraction. The vmapped axis of
        LibrarySweep(shared_scene=True)."""
        cfg = self.cfg
        cam = cfg.camera
        scene, weights, hd_lo, hd_hi, hand_delta = prep
        # Global (re-)registration ranks candidates separated by tens of
        # millimeters under grasp occlusion: there, hand-dropped pixels
        # must not drag the coverage of the genuinely occluded TRUE pose
        # (ScoreConfig.neutral_cov_exempt). Tracking keeps the plain
        # denominator — the exemption forms a gradient toward the hand
        # region that measurably hurt noisy mm-scale tracking (pinned
        # accuracy gates).
        score_cfg = (
            dataclasses.replace(cfg.score, neutral_cov_exempt=True)
            if init_scoring else cfg.score
        )
        axis_name = self.axis_name if self.mesh is not None else None
        prev_poses = prev_pose if prev_pose.ndim == 3 else prev_pose[None]
        n_hyp = prev_poses.shape[0]
        # workspace crop around the track (reference crops to a hand-centric
        # region of interest before ICP). If the crop would leave (nearly)
        # nothing — the prior has drifted clear of the observation — fall
        # back to the uncropped cloud: a blinded estimator (n_scene=0,
        # centroid=origin) can neither score honestly nor recapture via
        # explorer particles.
        roi_center = prev_poses[0, :3, 3]
        d2c = jnp.sum((scene.points - roi_center) ** 2, axis=-1)
        roi_w = weights * (d2c < roi_radius * roi_radius)
        weights = jnp.where(jnp.sum(roi_w) >= 32.0, roi_w, weights)

        # 3. swarm init: perturbations of prev_pose, or (global re-init)
        #    random orientations at the observed centroid.
        wsum = jnp.maximum(jnp.sum(weights), 1e-9)
        centroid = jnp.sum(scene.points * weights[:, None], 0) / wsum
        if n_hyp == 1:
            priors = prev_poses[0]
        else:
            # split the swarm among hypothesis priors: the best basin keeps
            # ~2/3, the backups share the rest (static assignment)
            per = max(1, (n_particles // 3) // (n_hyp - 1))
            counts = [n_particles - per * (n_hyp - 1)] + [per] * (n_hyp - 1)
            prior_idx = np.repeat(np.arange(n_hyp), counts)
            priors = prev_poses[prior_idx]                     # [P,4,4]
        tracked = se3.perturb_pose(
            k_init, priors, rot_sigma, trans_sigma, shape=(n_particles,)
        )
        kq, kt = jax.random.split(k_init)
        # low-discrepancy SO(3) coverage (randomly offset per call): iid
        # rotations leave large orientation holes at swarm sizes, and a
        # missed true basin = a pseudo-symmetric lock (see se3.
        # super_fibonacci_rotations)
        (model_pts, model_normals, render_pts, render_normals, render_w,
         symmetries) = obj_tensors
        kr = min(cfg.pso.scan_render_subset, render_pts.shape[0])

        # Second-order visibility (ScoreConfig.self_occlusion, VERDICT r4
        # item 2): back-face culling misses front-facing samples hidden
        # behind another part of the same object (concave geometry). Each
        # render sample's visibility is decided ONCE per frame — splat a
        # pose set, z-test each sample against the splat at its own
        # projection — and the resulting [Nr] mask rides through every
        # scoring tier. The mask is CANDIDATE-INDEPENDENT by design:
        # re-testing visibility per candidate against an incumbent map
        # injects candidate-dependent selection noise that measurably
        # DEGRADES fine-sigma rank-vs-error (A/B r5: tee 0.80 -> 0.68
        # per-pixel vs 0.80 -> 0.90 per-sample), while a frame-constant
        # sample subset is rank-neutral — the same argument that
        # justifies the finisher patch tables.
        #
        # The pose set is the SEARCH REGION, not just the incumbent:
        # each hypothesis prior plus self_occ_union draws at the swarm's
        # own (rot_sigma, trans_sigma) spread, visibility = union. A
        # mask frozen at the stale incumbent culls samples that ROTATE
        # INTO VIEW under fast unpredicted motion — biasing every tier
        # against exactly the moved true pose (measured r5, random-twist
        # occlusion protocol on the convex box, theta 30/50: 5.5/6.7 mm
        # tracked mean with the incumbent-only mask vs 1.6/1.7 with the
        # mask off; p90 tails 18-24 mm). Union over the region keeps any
        # sample visible SOMEWHERE the swarm will actually search, so
        # only true interior self-occlusion (mug cavity, bracket web —
        # hidden under every nearby pose) is culled. Track program only:
        # init candidates span SO(3), where any prior mask would be
        # wrong by construction.
        render_vis = None
        if (not init_scoring) and cfg.score.self_occlusion:
            n_hyp_m = prev_poses.shape[0]
            n_draw = cfg.score.self_occ_union
            k_mask = jax.random.fold_in(k_init, 7)
            region = se3.perturb_pose(
                k_mask,
                jnp.tile(prev_poses, (n_draw, 1, 1)),
                rot_sigma, trans_sigma, shape=(n_draw * n_hyp_m,),
            )
            mask_poses = jnp.concatenate([prev_poses, region], axis=0)
            inc_pts = se3.transform_points(mask_poses, render_pts)  # [M,Nr,3]
            inc_nrm = se3.rotate_vectors(mask_poses, render_normals)
            d_inc = render.splat_depth_batched(
                inc_pts, render_w,
                fx=self.lo_fx, fy=self.lo_fy, cx=self.lo_cx, cy=self.lo_cy,
                height=self.lo_h, width=self.lo_w, radius=1,
            )                                                       # [M,h,w]
            z = inc_pts[..., 2]
            zs = jnp.where(z > 1e-6, z, 1.0)
            ui = jnp.clip(jnp.round(
                inc_pts[..., 0] / zs * self.lo_fx + self.lo_cx
            ).astype(jnp.int32), 0, self.lo_w - 1)
            vi = jnp.clip(jnp.round(
                inc_pts[..., 1] / zs * self.lo_fy + self.lo_cy
            ).astype(jnp.int32), 0, self.lo_h - 1)
            d_at = jnp.take_along_axis(
                d_inc.reshape(d_inc.shape[0], -1),
                vi * self.lo_w + ui, axis=-1,
            )                                                       # [M,Nr]
            # Slope-scaled margin (the shadow-acne fix): the splat's min
            # over a (2r+1)^2 footprint reads the surface up to
            # (r+0.5) px closer laterally, which on a surface at angle
            # theta to the view ray is (r+0.5) * z/f_lo * tan(theta)
            # CLOSER in depth — at the lo grid's ~3.5 mm/px a fixed 8 mm
            # margin wrongly culled every steep box face (verify drive
            # 7 mm -> 60 mm before this term). tan is clamped: near-
            # grazing samples carry little depth evidence either way.
            ray = inc_pts / jnp.maximum(
                jnp.linalg.norm(inc_pts, axis=-1, keepdims=True), 1e-9)
            cosv = jnp.clip(-jnp.sum(inc_nrm * ray, axis=-1), 1e-3, 1.0)
            tanv = jnp.sqrt(1.0 - cosv**2) / cosv
            margin = cfg.score.self_occ_margin + (
                1.5 * (z / self.lo_fx) * jnp.minimum(tanv, 4.0)
            )
            # visible under ANY pose in the search region keeps the
            # sample (the splat includes the sample itself, so
            # d_at <= z always; hidden means another surface sits
            # > margin in front at EVERY region pose). NEAR-GRAZING
            # samples are exempt from culling outright: past the margin
            # clamp the splat's own-face footprint spread exceeds any
            # affordable margin, so the z-test is unreliable exactly
            # there — and culling them is what opened the box's lateral
            # slide mode (theta=50 grasp, r5: edge-on side faces culled
            # at every region pose + one silhouette side behind the
            # hand left the flat front face translation-invariant;
            # 6.6 mm tracked mean / 24 mm p90 vs 1.7 with the mask
            # off). True interior self-occlusion (mug cavity, bracket
            # web) is well-facing and keeps its cull.
            vis_any = jnp.any(d_at >= z - margin, axis=0)           # [Nr]
            grazing = jnp.any(
                tanv > cfg.score.self_occ_tan_max, axis=0)
            render_vis = vis_any | grazing

        def aligned_candidates(k_noise, rotations):
            """Candidate poses from orientations: per-orientation
            translation aligns the model's PREDICTED visible-surface
            centroid with the observed cloud centroid. The naive
            'object center at observed centroid' prior misses by up to
            half the object extent (measured r2: 48 mm on a grasped step
            object — outside the PSO+ICP convergence basin); aligning
            visible centroids is correct to the occlusion bias (~1 cm)."""
            n = rotations.shape[0]
            T0 = se3.make_pose(rotations, jnp.zeros((n, 3), rotations.dtype))
            pts_r = se3.transform_points(T0, render_pts[:kr])   # [n,kr,3]
            nrm_r = se3.rotate_vectors(T0, render_normals[:kr])
            vis_w = (nrm_r[..., 2] < 0.0) * render_w[:kr][None]  # camera +z
            wsum_r = jnp.maximum(jnp.sum(vis_w, -1, keepdims=True), 1e-6)
            m_vis = jnp.sum(pts_r * vis_w[..., None], 1) / wsum_r
            t = centroid[None] - m_vis + jax.random.normal(
                k_noise, (n, 3)) * (0.3 * trans_sigma)
            return se3.make_pose(rotations, t)

        if prescreen > n_particles:
            # init pre-screen: ONE scoring pass (no ICP) over a much
            # denser orientation grid than the swarm could carry; the
            # best n_particles become the swarm. Cost ~= one scan
            # iteration's scoring, paid once per (re-)registration.
            cand = aligned_candidates(
                kt, se3.super_fibonacci_rotations(prescreen, kq)
            )
            cand_fit, _ = pso.score_particles(
                cand, render_pts[:kr], render_normals[:kr], render_w[:kr],
                scene.depth, scene.valid, hd_lo,
                fx=self.lo_fx, fy=self.lo_fy, cx=self.lo_cx, cy=self.lo_cy,
                height=self.lo_h, width=self.lo_w,
                splat_radius=1, score_cfg=score_cfg,
                observed_enc=score_ops.encode_observed(
                    scene.depth, scene.valid, score_cfg.ghost_dilate,
                    neutral=scene.neutral,
                ),
            )
            # STRATIFIED seeding: half the swarm from the best raw scores,
            # half strided across the whole orientation grid regardless of
            # score. Pure top-K is over-exploitative: the un-refined score
            # of a correct-but-15-degrees-off candidate can rank below
            # hundreds of candidates clustered around a pseudo-symmetric
            # flip, and then NO seed lies in the true basin (measured r2:
            # exactly this locked a 14 mm flip on the step object while
            # the true basin scored 1.36 vs the flip's 0.77 once refined).
            n_top = n_particles // 2
            # Observation-side support for the top candidates (VERDICT r3
            # item 5): the raw projective ranking never pays for observed
            # points a pose fails to explain, so slid/flipped candidates
            # can dominate the top of the grid (measured r3: 48 mm slide
            # scored 1.455 vs 1.335 at truth). One batched NN on the
            # inner-ICP subsets adds the same w*(explained-1) term the
            # swarm fitness carries to the top prescreen_support
            # candidates, and the top-half seeds are picked WITHIN that
            # corrected subset. Correcting a subset then top_k-ing over
            # the mixed array is wrong: penalized good candidates fall
            # below never-penalized slides from the uncorrected tail
            # (measured: pinned cylinder t=17 flipped from 2.3 mm to a
            # 26.7 mm slide exactly that way). The subset must also be
            # strictly larger than n_top or the correction cannot change
            # the selected SET at all.
            n_sup = min(max(cfg.tracker.prescreen_support, 2 * n_top),
                        prescreen)
            if score_cfg.scene_cov_weight > 0.0 and \
                    cfg.tracker.prescreen_support > 0:
                km_i = min(
                    cfg.tracker.reinit_icp_model_subset if init_scoring
                    else cfg.pso.icp_model_subset,
                    model_pts.shape[0],
                )
                ks_i = min(cfg.pso.icp_scene_subset, scene.points.shape[0])
                _, sup_idx = jax.lax.top_k(cand_fit, n_sup)
                # tau is DOUBLED vs the swarm term: prescreen candidates
                # are unrefined (visible-centroid alignment is ~1 cm off),
                # so at the swarm tau the support signal is alignment
                # noise, not basin identity — measured: the pinned
                # cylinder t=17 flipped to a 26.7 mm slide at 1x tau and
                # recovered (2.3 mm) at 2x. Measured limit of this term:
                # it CANNOT replace the init-only neutral exemption — the
                # cylinder slide's discriminating evidence (the protruding
                # end) sits behind the hand-dropped region, so its support
                # is high no matter the tau (26.7 mm fail with exemption
                # off, support on or off).
                supp = icp_ops.scene_support(
                    cand[sup_idx], scene.points[:ks_i], weights[:ks_i],
                    model_pts[:km_i], tau=2.0 * score_cfg.scene_cov_tau,
                )
                corr_fit = cand_fit[sup_idx] + (
                    score_cfg.scene_cov_weight * (supp - 1.0)
                )
                _, best_in_sup = jax.lax.top_k(corr_fit, n_top)
                top = sup_idx[best_in_sup]
            else:
                _, top = jax.lax.top_k(cand_fit, n_top)
            stride_idx = np.linspace(
                0, prescreen - 1, n_particles - n_top
            ).round().astype(np.int32)
            global_init = jnp.concatenate([cand[top], cand[stride_idx]])
        else:
            global_init = aligned_candidates(
                kt, se3.super_fibonacci_rotations(n_particles, kq)
            )
        # explorer seeds: even while tracking, a slice of the global-init
        # grid re-runs the search each frame so a competitively-scoring
        # WRONG basin (possible under occlusion/near-symmetry) is
        # recaptured as soon as the true basin scores better — without
        # waiting for the fitness watchdog. Refined OUTSIDE the swarm
        # (ops/pso.py explorer_seeds): in-swarm explorer rows were
        # recycled by the elite resample before converging. Rows are
        # taken at an even STRIDE of the super-Fibonacci grid:
        # consecutive spiral rows (s -> 1) cluster near a circle
        # subgroup of SO(3). Only in tracked mode (prescreen==0): the
        # global search IS the broad search already.
        n_explore = int(round(n_particles * self.cfg.pso.explore_frac))
        explorer_seeds = None
        if n_explore > 0 and n_particles > n_explore and prescreen == 0:
            idx = np.linspace(
                0, n_particles - 1, n_explore
            ).round().astype(np.int32)
            explorer_seeds = global_init[idx]
        poses0 = jnp.where(uniform_rot, global_init, tracked)

        # 4. the PSO + ICP + render-and-compare device loop (L4).
        pso_cfg = dataclasses.replace(
            self.cfg.pso, particles=n_particles, iters=pso_iters,
            resample_after=resample_after,
        )
        if init_scoring:
            # global registration keeps the heavier in-scan ICP cadence
            # (TrackerConfig.reinit_icp_*): basin capture needs the pull,
            # and init cost is amortized over the tracked sequence
            tr = self.cfg.tracker
            pso_cfg = dataclasses.replace(
                pso_cfg,
                icp_iters_inner=tr.reinit_icp_iters_inner,
                icp_model_subset=tr.reinit_icp_model_subset,
            )
        result = pso.pso(
            k_pso, poses0,
            scene.points, scene.normals, weights,
            model_pts, model_normals,
            render_pts, render_normals, render_w,
            scene.depth, scene.valid, hd_lo,
            fx=self.lo_fx, fy=self.lo_fy, cx=self.lo_cx, cy=self.lo_cy,
            height=self.lo_h, width=self.lo_w,
            splat_radius=1,
            pso_cfg=pso_cfg, icp_cfg=cfg.icp, score_cfg=score_cfg,
            axis_name=axis_name,
            render_vis=render_vis,
            # continuity tie-break (PsoConfig.tie_break_eps): only when
            # this frame actually tracks from the prior (uniform_rot is
            # the traced re-init/global-init bool — same compiled program)
            prior_pose=prev_poses[0],
            prior_valid=jnp.logical_not(uniform_rot),
            explorer_seeds=explorer_seeds,
            observed_neutral=scene.neutral,
            observed_hi=(
                scene.depth_full, scene.valid_full, scene.neutral_full,
                hd_hi,
                cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width,
            ),
        )
        # Symmetry-branch snap (ops/pso.snap_to_branch): report the
        # best pose's symmetry-equivalent closest to the prior. Exact
        # twins render identically, so the fine-tier argmax otherwise
        # picks a branch per frame on sampling noise (box: ~90° hops in
        # the reported stream). Tracked frames only — on a global init
        # (uniform_rot) there is no meaningful prior branch.
        best_pose = result.best_pose
        if symmetries.shape[0] > 1:
            snapped = pso.snap_to_branch(
                best_pose, prev_poses[0], symmetries, model_pts)
            best_pose = jnp.where(uniform_rot, best_pose, snapped)
        # competing-basin hypotheses from the fine-tier candidate set
        # (slot 0 is always the finisher-refined best)
        hyp_poses, hyp_fitness = pso.diverse_hypotheses(
            result.cand_poses, result.cand_fitness, n_hyp,
            first_pose=best_pose, first_fitness=result.best_fitness,
        )
        return FrameResult(
            pose=best_pose,
            fitness=result.best_fitness,
            coverage=result.best_coverage,
            fitness_trace=result.fitness_trace,
            n_scene=jnp.sum(weights),
            hyp_poses=hyp_poses,
            hyp_fitness=hyp_fitness,
            # identity (not None) outside the auto-refine init path: a
            # constant pytree structure keeps one out_shardings spec
            # valid for BOTH compiled sweep programs (track + init)
            hand_delta=(jnp.eye(4, dtype=result.best_pose.dtype)
                        if hand_delta is None else hand_delta),
        )

    def _frame_step(
        self,
        key: jax.Array,
        depth_m: jax.Array,       # [H,W] meters
        prev_pose: jax.Array,     # [4,4], or [Hy,4,4] hypothesis priors
                                  # (row 0 = best; multi-hypothesis
                                  # tracking splits the swarm among them)
        hand_base: jax.Array,     # [4,4]
        hand_q: jax.Array,        # [J]
        obj_tensors: tuple,       # (model_pts, model_normals,
                                  #  render_pts, render_normals, render_w,
                                  #  symmetries [S,4,4])
        rot_sigma: jax.Array,     # traced: swarm init spread
        trans_sigma: jax.Array,
        uniform_rot: jax.Array,   # traced bool: global-init orientation prior
        roi_radius: jax.Array,    # traced: workspace crop radius (inf = off)
        *,
        n_particles: int,
        pso_iters: int,
        resample_after: int = 0,
        prescreen: int = 0,
        init_scoring: bool = False,
    ) -> FrameResult:
        """One full frame: scene prep + per-object search (the two halves
        are split so the sweep's shared-scene mode can reuse the prep; the
        key-split order here is load-bearing for bitwise reproducibility
        of pinned tests)."""
        k_hand, k_pre, k_init, k_pso = jax.random.split(key, 4)
        if self.mesh is not None:
            # Preprocessing (hand sampling, subsampling) must stay replicated
            # so per-shard fitness values are comparable and outputs are
            # bitwise-replicated; only the swarm RNG is shard-unique.
            idx = jax.lax.axis_index(self.axis_name)
            k_init = jax.random.fold_in(k_init, idx)
            k_pso = jax.random.fold_in(k_pso, idx)
        prep = self._scene_prep(
            k_hand, k_pre, depth_m, hand_base, hand_q, init_scoring
        )
        return self._search(
            k_init, k_pso, prep, prev_pose, obj_tensors,
            rot_sigma, trans_sigma, uniform_rot, roi_radius,
            n_particles=n_particles, pso_iters=pso_iters,
            resample_after=resample_after, prescreen=prescreen,
            init_scoring=init_scoring,
        )

    # -- public API ----------------------------------------------------------

    def frame_args(
        self,
        depth_m: jax.Array,
        prev_pose: jax.Array,
        hand_base: jax.Array | None = None,
        hand_q: jax.Array | None = None,
        key: jax.Array | None = None,
        *,
        mode: str = "track",
    ) -> tuple[tuple, dict]:
        """Validated (dynamic_args, static_kwargs) for the frame program —
        exactly what `estimate` passes to the jit. Exposed so benchmarks
        and profiling can AOT-lower the SAME program
        (`est._step_jit.lower(*dyn, **static)`) for XLA cost analysis
        without a second trace path."""
        cfg = self.cfg
        if key is None:
            key = jax.random.key(0)
        # API-boundary validation (SURVEY.md §6 sanitizers): shape errors
        # surface here as messages, not as jit shape-mismatch tracebacks.
        cam = cfg.camera
        if tuple(depth_m.shape) != (cam.height, cam.width):
            raise ValueError(
                f"depth shape {tuple(depth_m.shape)} != camera "
                f"({cam.height}, {cam.width}); fix CameraIntrinsics"
            )
        if tuple(prev_pose.shape)[-2:] != (4, 4) or prev_pose.ndim not in (2, 3):
            raise ValueError(
                f"prev_pose must be [4,4] or [n_hyp,4,4], got {prev_pose.shape}"
            )
        J = self.hand.n_joints if self.hand is not None else 1
        if hand_base is None or hand_q is None:
            if self._hand_defaults is None:
                self._hand_defaults = (jnp.eye(4), jnp.zeros((J,)))
            if hand_base is None:
                hand_base = self._hand_defaults[0]
            if hand_q is None:
                hand_q = self._hand_defaults[1]
        hand_q = jnp.asarray(hand_q)
        if self.hand is not None and hand_q.shape != (J,):
            raise ValueError(
                f"hand_q shape {tuple(hand_q.shape)} != ({J},) for this hand"
            )
        tr = cfg.tracker
        if mode == "track":
            args = dict(
                rot_sigma=cfg.pso.rot_sigma, trans_sigma=cfg.pso.trans_sigma,
                uniform_rot=False,
                roi_radius=max(1.5 * self.obj.diameter, 3.0 * cfg.pso.trans_sigma),
                n_particles=cfg.pso.particles, pso_iters=cfg.pso.iters,
            )
        elif mode == "init":
            args = dict(
                rot_sigma=tr.reinit_rot_sigma, trans_sigma=tr.reinit_trans_sigma,
                uniform_rot=True,
                roi_radius=np.inf,
                n_particles=tr.reinit_particles,
                pso_iters=max(cfg.pso.iters, 2 * cfg.pso.iters),
            )
            # explore-then-exploit: no diversity collapse for the first
            # half of the global search (PsoConfig.resample_after), and a
            # dense one-shot orientation pre-screen seeds the swarm
            args["resample_after"] = args["pso_iters"] // 2
            args["prescreen"] = tr.reinit_prescreen
        else:
            raise ValueError(f"unknown mode {mode!r}")
        # multi-hypothesis swarm split needs >= 1 particle per prior on
        # every shard (counts[0] in _frame_step would go non-positive and
        # np.repeat fails at trace time with an opaque error — ADVICE r2)
        n_hyp = prev_pose.shape[0] if prev_pose.ndim == 3 else 1
        per_shard = args["n_particles"] // (
            self.mesh.size if self.mesh is not None else 1
        )
        if n_hyp > 1 and per_shard < 2 * n_hyp:
            raise ValueError(
                f"{n_hyp} hypothesis priors need at least {2 * n_hyp} "
                f"particles per shard; got {per_shard} "
                f"(n_particles={args['n_particles']}"
                + (f" over {self.mesh.size} shards)" if self.mesh is not None
                   else ")")
            )
        consts = self._mode_consts.get(mode)
        if consts is None:
            consts = (
                jnp.asarray(args["rot_sigma"], jnp.float32),
                jnp.asarray(args["trans_sigma"], jnp.float32),
                jnp.asarray(args["uniform_rot"]),
                jnp.asarray(args["roi_radius"], jnp.float32),
            )
            self._mode_consts[mode] = consts
        dyn = (
            key, depth_m, prev_pose, hand_base, hand_q,
            (self.obj.model_pts, self.obj.model_normals,
             self.obj.render_pts, self.obj.render_normals, self.obj.render_w,
             self.obj.symmetries),
            *consts,
        )
        static = dict(
            n_particles=args["n_particles"], pso_iters=args["pso_iters"],
            resample_after=args.get("resample_after", 0),
            prescreen=args.get("prescreen", 0),
            init_scoring=(mode == "init"),
        )
        return dyn, static

    def estimate(
        self,
        depth_m: jax.Array,
        prev_pose: jax.Array,
        hand_base: jax.Array | None = None,
        hand_q: jax.Array | None = None,
        key: jax.Array | None = None,
        *,
        mode: str = "track",
    ) -> FrameResult:
        """One frame -> SE(3). mode='track' perturbs prev_pose; mode='init'
        runs the broad global search (first frame / tracking-loss recovery,
        SURVEY.md §4.3)."""
        dyn, static = self.frame_args(
            depth_m, prev_pose, hand_base, hand_q, key, mode=mode
        )
        return self._step_jit(*dyn, **static)


class TrackerState(NamedTuple):
    """Small pytree — the whole resumable tracker state (SURVEY.md §6
    checkpoint/resume)."""
    pose: jax.Array        # [4,4] last committed pose
    frame_idx: int         # host-side counter (a device int would cost a
                           # device->host fetch per frame in TrackResult)
    key: jax.Array         # rng key
    initialized: jax.Array  # bool
    fitness: jax.Array     # last frame's fitness
    coverage: jax.Array | None = None    # last frame's coverage (watchdog)
    hyp_poses: jax.Array | None = None   # [H,4,4] competing basins (H>1)
    hyp_fitness: jax.Array | None = None  # [H]
    prev_pose: jax.Array | None = None   # [4,4] pose one frame earlier
                                         # (constant-velocity prior)
    pose_tracked: bool = False           # True iff `pose` came from a
                                         # TRACKED frame (not an init) —
                                         # a delta based on an init pose
                                         # would fold the init's residual
                                         # into the velocity estimate
    hand_delta: jax.Array | None = None  # [4,4] accumulated hand-mount
                                         # base correction from auto-
                                         # armed init refinements (the
                                         # extrinsic error is constant,
                                         # so every reported base is
                                         # pre-multiplied with this —
                                         # tracked frames get corrected
                                         # masks at zero per-frame cost)


class TrackResult(NamedTuple):
    pose: jax.Array
    fitness: jax.Array
    coverage: jax.Array
    reinitialized: bool
    frame_idx: int
    hyp_poses: jax.Array | None = None   # [H,4,4] when n_hypotheses > 1
    hyp_fitness: jax.Array | None = None


class Tracker:
    """Frame-to-frame propagation + re-registration watchdog (§4.4).

    Host-side loop carrying TrackerState; falls back to global
    re-initialization when fitness collapses (BASELINE config 4)."""

    def __init__(self, est: Estimator, seed: int = 0):
        self.est = est
        self.state = TrackerState(
            pose=jnp.eye(4),
            frame_idx=0,
            key=jax.random.key(seed),
            initialized=jnp.asarray(False),
            fitness=jnp.asarray(0.0),
            coverage=jnp.asarray(1.0),
        )
        # step()'s per-frame glue (RNG split, watchdog predicate, prior
        # construction) is ONE jitted program: run eagerly it was ~10
        # small device dispatches + 3 scalar fetches, and each fetch
        # serializes against the in-flight frame. Jitted glue + ONE
        # packed watchdog fetch + the speculative dispatch in step()
        # leave one dispatch and one tiny fetch per frame.
        self._prep_jit = jax.jit(self._prep)
        self._true = jnp.asarray(True)

    def _prep(self, st: TrackerState, hand_base=None):
        """Jitted per-frame glue: RNG split, the watchdog predicate
        (packed into ONE bool for a single host fetch), both modes'
        prior stacks, and the hand-delta-corrected base (None passes
        through; the correction multiply rides in this one program
        instead of costing an eager dispatch per frame)."""
        tr_cfg = self.est.cfg.tracker
        H = tr_cfg.n_hypotheses
        alpha = tr_cfg.motion_prior
        key, sub = jax.random.split(st.key)
        # fitness collapse OR coverage collapse: fitness is a per-counted-
        # sample average, so a drifted pose that sheds its evidence pixels
        # can stay "confident" (documented mode: 71 mm wrong, fitness
        # 0.99, coverage 0.007 — score.py header). Coverage collapse is
        # the second line of defense the fitness test cannot provide.
        need_init = ~st.initialized | (
            st.fitness < tr_cfg.fitness_reinit_threshold
        )
        if tr_cfg.coverage_reinit_threshold > 0.0 and st.coverage is not None:
            need_init |= st.initialized & (
                st.coverage < tr_cfg.coverage_reinit_threshold
            )
        if H > 1 and st.hyp_poses is not None:
            # carry every competing basin forward; slots that never held a
            # distinct basin (fitness -inf) re-seed from the best pose
            prev_t = jnp.where(
                jnp.isfinite(st.hyp_fitness)[:, None, None],
                st.hyp_poses, st.pose[None],
            )
        elif H == 1 and alpha > 0.0:
            # Constant-velocity prior: the swarm splits between the last
            # pose AND its extrapolation by (a damped power of) the last
            # frame-to-frame delta. Exact for constant rigid motion; the
            # raw last pose stays a prior so a bad previous delta cannot
            # lose the track. The 2-prior shape is used from the FIRST
            # tracked frame (delta = identity then) so track mode stays
            # one compiled program.
            if st.prev_pose is not None:
                delta = se3.compose(st.pose, se3.inverse(st.prev_pose))
                if alpha != 1.0:
                    delta = se3.se3_exp(alpha * se3.se3_log(delta))
                predicted = se3.compose(delta, st.pose)
            else:
                predicted = st.pose
            prev_t = jnp.stack([predicted, st.pose])
        else:
            prev_t = jnp.tile(st.pose[None], (H, 1, 1)) if H > 1 else st.pose
        prev_i = jnp.tile(st.pose[None], (H, 1, 1)) if H > 1 else st.pose
        if hand_base is not None and st.hand_delta is not None:
            hand_base = se3.compose(st.hand_delta, jnp.asarray(hand_base))
        return key, sub, prev_t, prev_i, need_init, hand_base

    def step(
        self,
        depth_m: jax.Array,
        hand_base: jax.Array | None = None,
        hand_q: jax.Array | None = None,
    ) -> TrackResult:
        st = self.state
        H = self.est.cfg.tracker.n_hypotheses
        key, sub, prev_t, prev_i, need_init_dev, hand_base = self._prep_jit(
            st, hand_base
        )
        # NOTE: bool(need_init) forces one host round-trip per frame. It
        # is unavoidable because the watchdog decision switches between
        # two DIFFERENT compiled programs (track vs init differ in
        # n_particles/pso_iters, which are static shapes) — a device-side
        # lax.cond cannot change program shape. When the LAST frame was
        # tracked (the steady state), the track program is dispatched
        # SPECULATIVELY before the watchdog bool is read, so the fetch's
        # round-trip hides under device compute instead of serializing in
        # front of it. A re-init frame then wastes one track execution —
        # rare by construction.
        out = None
        if st.pose_tracked:
            out = self.est.estimate(
                depth_m, prev_t, hand_base, hand_q, key=sub, mode="track"
            )
        need_init = bool(need_init_dev)
        if out is None or need_init:
            mode = "init" if need_init else "track"
            out = self.est.estimate(
                depth_m, prev_i if need_init else prev_t, hand_base, hand_q,
                key=sub, mode=mode,
            )
        # accumulate the auto-armed base correction (init frames only;
        # exact identity when the margin-accept rejected, so composing
        # is a no-op then). The program saw the ALREADY-corrected base,
        # so its delta composes LEFT of the running total. One eager
        # 4x4 matmul per (rare) init frame — tracked frames never pay.
        hand_delta = st.hand_delta
        hc = self.est.cfg.hand
        if (need_init and self.est.hand is not None
                and hc.base_refine_auto and hc.base_refine_iters == 0):
            hand_delta = (out.hand_delta if hand_delta is None
                          else se3.compose(out.hand_delta, hand_delta))
        self.state = TrackerState(
            pose=out.pose,
            frame_idx=st.frame_idx + 1,
            key=key,
            initialized=self._true,
            fitness=out.fitness,
            coverage=out.coverage,
            hyp_poses=out.hyp_poses if H > 1 else None,
            hyp_fitness=out.hyp_fitness if H > 1 else None,
            # velocity restarts after a (re-)init — AND for one more
            # frame: a delta whose base is the init pose folds the init's
            # residual (up to ~cm on a hard shape) into the "velocity"
            # and extrapolates it, seeding 2/3 of the next swarm wrong
            prev_pose=(st.pose if (not need_init and st.pose_tracked)
                       else None),
            pose_tracked=not need_init,
            hand_delta=hand_delta,
        )
        return TrackResult(
            pose=out.pose, fitness=out.fitness, coverage=out.coverage,
            reinitialized=need_init, frame_idx=int(st.frame_idx),
            hyp_poses=out.hyp_poses if H > 1 else None,
            hyp_fitness=out.hyp_fitness if H > 1 else None,
        )

    # -- checkpoint / resume (SURVEY.md §6) ----------------------------------

    def save(self, path: str) -> None:
        st = self.state
        extra = {}
        if st.hyp_poses is not None:
            extra = dict(
                hyp_poses=np.asarray(st.hyp_poses),
                hyp_fitness=np.asarray(st.hyp_fitness),
            )
        if st.prev_pose is not None:
            extra["prev_pose"] = np.asarray(st.prev_pose)
        if st.hand_delta is not None:
            extra["hand_delta"] = np.asarray(st.hand_delta)
        np.savez(
            _ckpt_path(path),
            pose=np.asarray(st.pose),
            frame_idx=np.asarray(st.frame_idx),
            key=np.asarray(jax.random.key_data(st.key)),
            initialized=np.asarray(st.initialized),
            fitness=np.asarray(st.fitness),
            coverage=np.asarray(
                st.coverage if st.coverage is not None else 1.0
            ),
            pose_tracked=np.asarray(st.pose_tracked),
            **extra,
        )

    def load(self, path: str) -> None:
        z = np.load(_ckpt_path(path))
        self.state = TrackerState(
            pose=jnp.asarray(z["pose"]),
            frame_idx=int(z["frame_idx"]),
            key=jax.random.wrap_key_data(jnp.asarray(z["key"])),
            initialized=jnp.asarray(bool(z["initialized"])),
            fitness=jnp.asarray(z["fitness"]),
            coverage=(
                jnp.asarray(z["coverage"]) if "coverage" in z
                else jnp.asarray(1.0)
            ),
            hyp_poses=jnp.asarray(z["hyp_poses"]) if "hyp_poses" in z else None,
            hyp_fitness=(
                jnp.asarray(z["hyp_fitness"]) if "hyp_fitness" in z else None
            ),
            prev_pose=(
                jnp.asarray(z["prev_pose"]) if "prev_pose" in z else None
            ),
            # pre-field checkpoints: a stored prev_pose implies the pose
            # was tracked
            pose_tracked=(
                bool(z["pose_tracked"]) if "pose_tracked" in z
                else "prev_pose" in z
            ),
            hand_delta=(
                jnp.asarray(z["hand_delta"]) if "hand_delta" in z else None
            ),
        )
