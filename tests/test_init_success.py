"""Global-registration success regression gate (VERDICT r2 item 1).

The VGA bench (`bench.py --init`) sweeps all six shapes at VGA with 30
trials each (r3 measured: worst shape 93.3%, counting one-frame
recovery). This reduced CPU-mesh version pins the capability so a
regression in the init pipeline (orientation prescreen, explorer seeds,
visible-centroid alignment) fails the suite: two shapes — the easy
ellipsoid and the documented hard case (near-symmetric 'asym' under
grasp occlusion) — at 320x240, a handful of random-orientation trials,
success = dense ADD-S < 10% of diameter, with the same one-tracked-frame
recovery credit the bench gives (the explorer pipeline re-runs a slice
of the global search every tracked frame, so a frame-0 flip that frame 1
fixes is a working system, not a failure).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from icra20_hand_object_pose_tpu.datasets import (
    hand_base_for_grasp, render_frame,
)
from icra20_hand_object_pose_tpu.evaluation import add_s_error
from icra20_hand_object_pose_tpu.models import (
    Estimator, ObjectModel, make_t42_hand,
)
from icra20_hand_object_pose_tpu.utils import meshio, se3
from icra20_hand_object_pose_tpu.utils.config import (
    CameraIntrinsics, EstimatorConfig, PsoConfig, TrackerConfig,
)

CAM = CameraIntrinsics(width=320, height=240, fx=285.0, fy=285.0,
                       cx=160.0, cy=120.0)
N_TRIALS = 5


@pytest.mark.parametrize("shape,min_ok", [("ellipsoid", 4), ("asym", 4)])
def test_global_init_success(shape, min_ok):
    cfg = EstimatorConfig(
        camera=CAM, scene_points=1024,
        pso=PsoConfig(particles=256, iters=10),
        tracker=TrackerConfig(reinit_particles=512),
    )
    mesh = meshio.make_test_object(shape)
    hand = make_t42_hand()
    obj = ObjectModel(mesh, model_points=1024, render_points=1024)
    est = Estimator(obj, hand, cfg)
    dense, _ = mesh.sample_surface(8192, seed=123)
    hq = np.asarray([0.45, 0.45], np.float32)
    rng = np.random.default_rng(0)
    keys = jax.random.split(jax.random.key(0), N_TRIALS)
    n_ok = 0
    for t in range(N_TRIALS):
        R = np.asarray(se3.random_rotation(jax.random.fold_in(keys[t], 1)))
        pose_gt = np.eye(4, dtype=np.float32)
        pose_gt[:3, :3] = R
        pose_gt[:3, 3] = [rng.uniform(-0.06, 0.06), rng.uniform(-0.05, 0.05),
                          rng.uniform(0.40, 0.60)]
        hb = hand_base_for_grasp(pose_gt)
        depth = render_frame(
            mesh, pose_gt, hand, hb, hq, CAM, noise_sigma=0.001,
            rng=np.random.default_rng(1000 + t),
        )
        out = est.estimate(
            jnp.asarray(depth), jnp.eye(4), jnp.asarray(hb), jnp.asarray(hq),
            key=keys[t], mode="init",
        )
        if add_s_error(np.asarray(out.pose), pose_gt, dense) < 0.1 * obj.diameter:
            n_ok += 1
            continue
        # one tracked frame on a slightly-moved view (recovery credit)
        pose1 = np.asarray(se3.perturb_pose(
            jax.random.fold_in(keys[t], 2), jnp.asarray(pose_gt),
            0.035, 0.002)).astype(np.float32)
        hb1 = (pose1 @ np.linalg.inv(pose_gt) @ hb).astype(np.float32)
        depth1 = render_frame(
            mesh, pose1, hand, hb1, hq, CAM, noise_sigma=0.001,
            rng=np.random.default_rng(2000 + t),
        )
        out1 = est.estimate(
            jnp.asarray(depth1), out.pose, jnp.asarray(hb1), jnp.asarray(hq),
            key=jax.random.fold_in(keys[t], 3), mode="track",
        )
        n_ok += add_s_error(np.asarray(out1.pose), pose1, dense) < 0.1 * obj.diameter
    assert n_ok >= min_ok, f"{shape}: only {n_ok}/{N_TRIALS} recovered"


@pytest.mark.parametrize("shape,trial", [("box", 17), ("cylinder", 17)])
def test_grasp_occluded_slide_case(shape, trial):
    """Pinned hardest-case trials from the round-3 init diagnosis (the
    same RNG stream as the 20-trial sweep, trial t=17): a grasp drops
    exactly the depth evidence that disambiguates a large axial
    slide/flip, and before the _NEUTRAL pixel class (encode_observed
    neutral=..., ScoreConfig.neutral_cov_exempt in init mode) the true
    pose paid ghost-penalty + coverage for hand-hidden samples and LOST
    the fine-tier ranking to a 24-47 mm slide. Frame-0 success required
    — this is the failure class the neutral class fixes."""
    cfg = EstimatorConfig(
        camera=CAM, scene_points=1024,
        pso=PsoConfig(particles=256, iters=10),
        tracker=TrackerConfig(reinit_particles=512),
    )
    mesh = meshio.make_test_object(shape)
    hand = make_t42_hand()
    obj = ObjectModel(mesh, model_points=1024, render_points=1024)
    est = Estimator(obj, hand, cfg)
    dense, _ = mesh.sample_surface(8192, seed=123)
    hq = np.asarray([0.45, 0.45], np.float32)
    # reproduce the diagnosis RNG stream: 3 uniforms consumed per trial
    rng = np.random.default_rng(0)
    draws = rng.uniform(size=(trial + 1, 3))
    keys = jax.random.split(jax.random.key(0), 20)
    R = np.asarray(se3.random_rotation(jax.random.fold_in(keys[trial], 1)))
    pose_gt = np.eye(4, dtype=np.float32)
    pose_gt[:3, :3] = R
    u = draws[trial]
    pose_gt[:3, 3] = [-0.06 + 0.12 * u[0], -0.05 + 0.10 * u[1],
                      0.40 + 0.20 * u[2]]
    hb = hand_base_for_grasp(pose_gt)
    depth = render_frame(
        mesh, pose_gt, hand, hb, hq, CAM, noise_sigma=0.001,
        rng=np.random.default_rng(1000 + trial),
    )
    out = est.estimate(
        jnp.asarray(depth), jnp.eye(4), jnp.asarray(hb), jnp.asarray(hq),
        key=keys[trial], mode="init",
    )
    err = add_s_error(np.asarray(out.pose), pose_gt, dense)
    assert err < 0.1 * obj.diameter, (
        f"{shape} t={trial}: frame-0 init ADD-S {err*1000:.1f} mm — "
        f"grasp-occluded slide case regressed"
    )
