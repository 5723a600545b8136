"""Occlusion-robustness regression gates (VERDICT r3 item 2, widened to
the whole curve + the composed realistic regime in r5 per VERDICT r4
item 4).

The measured headline curve (scripts/eval_occlusion.py, VGA, 512p,
2 seeds x 8 frames, exact-raster observed data, 2026-08-19 r5) tracks
flat in occlusion; these gates pin LOW / MID / HEAVY levels plus ONE
realistic-sensor + miscalibrated-hand combo at reduced res (320x240,
256p), so a regression anywhere along the occlusion machinery (neutral
class, occluder masks, config selection, base auto-refine) fails the
suite rather than only the single heaviest point (the r4 gate).

Reduced res carries ~2x the VGA quantization floor; gates hold margin
over the measured reduced-res numbers recorded per-level below.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from icra20_hand_object_pose_tpu.datasets import (
    SensorModel, hand_base_for_grasp, render_frame,
)
from icra20_hand_object_pose_tpu.evaluation import add_s_error
from icra20_hand_object_pose_tpu.models import (
    Estimator, ObjectModel, Tracker, make_t42_hand,
)
from icra20_hand_object_pose_tpu.utils import meshio, se3
from icra20_hand_object_pose_tpu.utils.config import (
    CameraIntrinsics, EstimatorConfig, PsoConfig, TrackerConfig,
)

CAM = CameraIntrinsics(width=320, height=240, fx=285.0, fy=285.0,
                       cx=160.0, cy=120.0)


def frontal_grasp_base(object_pose, theta_deg, offset=0.10):
    """Grasp approach rotated toward the camera (see
    scripts/eval_occlusion.py): theta=78 puts palm + both fingers
    between camera and object — ~55-65%% of the object hidden."""
    T = np.asarray(object_pose, np.float32)
    c = T[:3, 3]
    th = np.radians(theta_deg)
    z_h = np.array([np.cos(th), 0.0, np.sin(th)], np.float32)
    y_h = np.array([0.0, 1.0, 0.0], np.float32)
    x_h = np.cross(y_h, z_h).astype(np.float32)
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = np.stack([x_h, y_h, z_h], axis=1)
    out[:3, 3] = c - z_h * offset
    return out


# (level name, theta_deg [0 = side grasp], realistic, max ADD-S mm).
# VGA occlusion at these thetas (scripts/eval_occlusion.py): side ~18%,
# theta=50 ~36-47%, theta=78 ~55-65%.
LEVELS = [
    ("low_18pct", 0.0, False, 6.0),
    ("mid_47pct", 50.0, False, 6.0),
    ("heavy_63pct", 78.0, False, 8.0),
    # the two stressors composed (never before r5): realistic sensor
    # (1 mm quantization, z^2 noise, edge jitter) + 3 deg / 5 mm hand
    # calibration error + wrong nominal q, under heavy occlusion. Runs
    # the REAL protocol — frame 0 is a global init through the public
    # API, where the auto-armed base refinement (HandConfig.
    # base_refine_auto) must catch the miscalibration from the
    # agreement gain alone, and the Tracker must CARRY the accepted
    # correction into every tracked frame (TrackerState.hand_delta) —
    # a tracked frame fed the raw miscalibrated base builds wrong masks
    # and locks a far basin (measured r5: 66 mm on every frame).
    ("realistic_heavy", 78.0, True, 10.0),
]


@pytest.mark.parametrize(
    "name,theta,realistic,gate_mm", LEVELS, ids=[r[0] for r in LEVELS])
def test_tracking_under_occlusion(name, theta, realistic, gate_mm):
    cfg = EstimatorConfig(
        camera=CAM, scene_points=1024,
        pso=PsoConfig(particles=256, iters=10),
        tracker=TrackerConfig(reinit_particles=512),
    )
    mesh = meshio.make_test_object("asym")
    hand = make_t42_hand()
    obj = ObjectModel(mesh, model_points=1024, render_points=1024)
    dense, _ = mesh.sample_surface(8192, seed=123)
    hq = np.asarray([0.45, 0.45], np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, 0.5]
    hb = (frontal_grasp_base(pose, theta) if theta > 0
          else hand_base_for_grasp(pose))
    q_true, sensor, base_err = hq, None, np.eye(4, dtype=np.float32)
    if realistic:
        sensor = SensorModel()
        cal = np.random.default_rng(41)
        w = cal.normal(size=3)
        w = w / np.linalg.norm(w) * np.radians(3.0)
        v = cal.normal(size=3)
        v = v / np.linalg.norm(v) * 5e-3
        base_err = np.asarray(se3.se3_exp(jnp.asarray(
            np.concatenate([w, v]), jnp.float32)))
        q_true = (hq + 0.15).astype(np.float32)
    est = Estimator(obj, hand, cfg)
    tracker = Tracker(est, seed=0)
    if not realistic:
        # isolate TRACKING: seed the true pose (the non-realistic levels
        # pin the occlusion machinery, not global init)
        tracker.state = tracker.state._replace(
            pose=jnp.asarray(pose), initialized=jnp.asarray(True),
            fitness=jnp.asarray(1.0),
        )
    rng = np.random.default_rng(7000)
    key = jax.random.key(97)
    cur = pose
    errs, covs = [], []
    for f in range(4):
        key, k1 = jax.random.split(key)
        if f > 0:
            nxt = np.asarray(se3.perturb_pose(
                k1, jnp.asarray(cur), 0.05, 0.004)).astype(np.float32)
            hb = (nxt @ np.linalg.inv(cur) @ hb).astype(np.float32)
            cur = nxt
        dep = render_frame(mesh, cur, hand, hb, q_true, CAM,
                           noise_sigma=0.001, rng=rng, sensor=sensor)
        hb_rep = (base_err @ hb).astype(np.float32)
        res = tracker.step(jnp.asarray(dep), jnp.asarray(hb_rep),
                           jnp.asarray(hq))
        covs.append(float(res.coverage))
        if f > 0:
            errs.append(add_s_error(np.asarray(res.pose), cur, dense))
    assert max(errs) * 1000 < gate_mm, [round(e * 1e3, 2) for e in errs]
    # the watchdog must neither misfire (coverage above threshold) nor
    # be needed (no frame re-initialized)
    assert min(covs) > cfg.tracker.coverage_reinit_threshold, covs
