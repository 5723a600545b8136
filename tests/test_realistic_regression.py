"""Realistic-regime regression gates (VERDICT r3 item 3).

The r1-r3 robustness numbers were measured in a favorable regime: flat
1 mm Gaussian depth noise, exact hand base pose, exact nominal joint
angles. This file pins behavior under the REALISTIC model —
datasets.SensorModel (1 mm quantization = the 16-bit PNG LSB, depth^2
noise growth, lateral edge jitter) plus hand CALIBRATION error (base
pose 5 mm / 3 deg off, nominal q 0.15 rad from the true closure) — at
reduced res on the CPU mesh. Measured headline (30 trials/shape at
VGA, bench --init-realistic): worst shape 93.3% init success, all
shapes 93-100%.

Thresholds = CPU measurements (2026-08-19) + margin:
  - tracking (from GT init): ellipsoid stayed 1.9-2.5 mm; asym took a
    20-30 mm excursion on the first frames (wrong hand masks drop the
    wrong pixels) and self-recovered to ~1.1 mm by frame 3 — the gate
    pins the RECOVERED end state, not the transient.
  - init: 5/5 on both shapes; gate at >=3/4.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from icra20_hand_object_pose_tpu.datasets import (
    SensorModel, SyntheticSequenceConfig, generate_sequence,
    hand_base_for_grasp, render_frame,
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


def make_cfg():
    return EstimatorConfig(
        camera=CAM, scene_points=1024,
        pso=PsoConfig(particles=256, iters=10),
        tracker=TrackerConfig(reinit_particles=512),
    )


@pytest.mark.parametrize("shape,final_mm", [("ellipsoid", 5.0), ("asym", 7.0)])
def test_realistic_tracking(shape, final_mm):
    mesh = meshio.make_test_object(shape)
    hand = make_t42_hand()
    obj = ObjectModel(mesh, model_points=1024, render_points=1024)
    dense, _ = mesh.sample_surface(8192, seed=123)
    seq = generate_sequence(mesh, hand, SyntheticSequenceConfig(
        n_frames=3, camera=CAM, sensor=SensorModel(),
        hand_base_err_mm=5.0, hand_base_err_deg=3.0,
        hand_q_true_offset=0.15, seed=3,
    ))
    tracker = Tracker(Estimator(obj, hand, make_cfg()), seed=0)
    tracker.state = tracker.state._replace(
        pose=jnp.asarray(seq[0].pose_gt),
        initialized=jnp.asarray(True), fitness=jnp.asarray(1.0),
    )
    errs, covs = [], []
    for fr in seq:
        out = tracker.step(jnp.asarray(fr.depth), jnp.asarray(fr.hand_base),
                           jnp.asarray(fr.hand_q))
        errs.append(add_s_error(np.asarray(out.pose), fr.pose_gt, dense))
        covs.append(float(out.coverage))
    assert errs[-1] * 1000 < final_mm, [round(e * 1e3, 2) for e in errs]
    # the coverage watchdog must not misfire under calibration error
    assert min(covs) > make_cfg().tracker.coverage_reinit_threshold, covs


@pytest.mark.parametrize("shape", ["ellipsoid", "asym"])
def test_realistic_init(shape):
    """Global registration under the realistic model: the estimator
    receives a hand base 5 mm / 3 deg off and a nominal q 0.15 rad off
    the closure that rendered the frame."""
    N, MIN_OK = 4, 3
    mesh = meshio.make_test_object(shape)
    hand = make_t42_hand()
    obj = ObjectModel(mesh, model_points=1024, render_points=1024)
    est = Estimator(obj, hand, make_cfg())
    dense, _ = mesh.sample_surface(8192, seed=123)
    hq = np.asarray([0.45, 0.45], np.float32)
    rng = np.random.default_rng(0)
    keys = jax.random.split(jax.random.key(0), N)
    sm = SensorModel()
    n_ok = 0
    for t in range(N):
        R = np.asarray(se3.random_rotation(jax.random.fold_in(keys[t], 1)))
        gt = np.eye(4, dtype=np.float32)
        gt[:3, :3] = R
        gt[:3, 3] = [rng.uniform(-0.06, 0.06), rng.uniform(-0.05, 0.05),
                     rng.uniform(0.40, 0.60)]
        hb = hand_base_for_grasp(gt)
        cal = np.random.default_rng(7000 + t)
        w = cal.normal(size=3)
        w = w / np.linalg.norm(w) * np.radians(3.0)
        v = cal.normal(size=3)
        v = v / np.linalg.norm(v) * 5e-3
        err_T = np.asarray(se3.se3_exp(jnp.asarray(
            np.concatenate([w, v]), jnp.float32)))
        hb_rep = (err_T @ hb).astype(np.float32)
        q_true = (hq + cal.choice([-0.15, 0.15])).astype(np.float32)
        depth = render_frame(mesh, gt, hand, hb, q_true, CAM,
                                  rng=np.random.default_rng(1000 + t),
                                  sensor=sm)
        out = est.estimate(jnp.asarray(depth), jnp.eye(4),
                           jnp.asarray(hb_rep), jnp.asarray(hq),
                           key=keys[t], mode="init")
        e = add_s_error(np.asarray(out.pose), gt, dense)
        if e < 0.1 * obj.diameter:
            n_ok += 1
            continue
        # one tracked recovery frame (same credit as the VGA bench)
        p1 = np.asarray(se3.perturb_pose(
            jax.random.fold_in(keys[t], 2), jnp.asarray(gt),
            0.035, 0.002)).astype(np.float32)
        hb1 = (p1 @ np.linalg.inv(gt) @ hb).astype(np.float32)
        hb1_rep = (p1 @ np.linalg.inv(gt) @ hb_rep).astype(np.float32)
        d1 = render_frame(mesh, p1, hand, hb1, q_true, CAM,
                               rng=np.random.default_rng(2000 + t),
                               sensor=sm)
        out1 = est.estimate(jnp.asarray(d1), out.pose,
                            jnp.asarray(hb1_rep), jnp.asarray(hq),
                            key=jax.random.fold_in(keys[t], 3), mode="track")
        n_ok += add_s_error(np.asarray(out1.pose), p1, dense) < 0.1 * obj.diameter
    assert n_ok >= MIN_OK, f"{shape}: {n_ok}/{N} under the realistic model"


def test_realistic_tracking_base_refine_removes_excursion():
    """With the hand-mount base refinement on (HandConfig.base_refine_iters,
    models/hand.refine_base), the calibration-error mask excursion that
    test_realistic_tracking tolerates must be GONE — not just recovered
    from. Measured on this exact sequence (CPU, 2026-08-19): per-frame
    ADD-S [28.5, 18.2, 1.1] mm without refinement -> [1.5, 1.6, 1.1] mm
    with it. Gate at <8 mm EVERY frame (3 sigma of PSO seed noise above
    the 1.6 measurement, far below the 18-28 mm excursion)."""
    mesh = meshio.make_test_object("asym")
    hand = make_t42_hand()
    obj = ObjectModel(mesh, model_points=1024, render_points=1024)
    dense, _ = mesh.sample_surface(8192, seed=123)
    seq = generate_sequence(mesh, hand, SyntheticSequenceConfig(
        n_frames=3, camera=CAM, sensor=SensorModel(),
        hand_base_err_mm=5.0, hand_base_err_deg=3.0,
        hand_q_true_offset=0.15, seed=3,
    ))
    from icra20_hand_object_pose_tpu.utils.config import HandConfig
    cfg = EstimatorConfig(
        camera=CAM, scene_points=1024,
        pso=PsoConfig(particles=256, iters=10),
        tracker=TrackerConfig(reinit_particles=512),
        hand=HandConfig(base_refine_iters=3),
    )
    tracker = Tracker(Estimator(obj, hand, cfg), seed=0)
    tracker.state = tracker.state._replace(
        pose=jnp.asarray(seq[0].pose_gt),
        initialized=jnp.asarray(True), fitness=jnp.asarray(1.0),
    )
    errs = []
    for fr in seq:
        out = tracker.step(jnp.asarray(fr.depth), jnp.asarray(fr.hand_base),
                           jnp.asarray(fr.hand_q))
        errs.append(add_s_error(np.asarray(out.pose), fr.pose_gt, dense))
    assert max(errs) * 1000 < 8.0, [round(e * 1e3, 2) for e in errs]


def test_sensor_model_properties():
    """The sensor model's components behave as specified: quantization
    to exact millimeters, noise growing with depth, edges jittering
    while flat interiors stay put."""
    from icra20_hand_object_pose_tpu.datasets import apply_sensor_model

    rng = np.random.default_rng(0)
    d = np.full((64, 64), 0.5, np.float32)
    d[:, 32:] = 1.0                       # a depth step edge
    # quantization only
    sm = SensorModel(noise_sigma=0.0, quantize=0.001, edge_sigma_px=0.0,
                     dropout=0.0)
    out = apply_sensor_model(d, sm, rng)
    assert np.allclose(out * 1000, np.round(out * 1000))
    # z^2 noise growth: sigma at 1.0 m must be ~4x sigma at 0.5 m
    sm = SensorModel(noise_sigma=0.002, quantize=0.0, edge_sigma_px=0.0,
                     dropout=0.0)
    out = apply_sensor_model(d, sm, np.random.default_rng(1))
    s_near = np.std(out[:, :32] - 0.5)
    s_far = np.std(out[:, 32:] - 1.0)
    assert 2.5 < s_far / s_near < 6.0, (s_near, s_far)
    # lateral edge jitter: flat interior unchanged, edge column wobbles
    sm = SensorModel(noise_sigma=0.0, quantize=0.0, edge_sigma_px=0.7,
                     dropout=0.0)
    out = apply_sensor_model(d, sm, np.random.default_rng(2))
    assert np.allclose(out[:, :16], 0.5)
    assert np.any(out[:, 31:33] != d[:, 31:33])
