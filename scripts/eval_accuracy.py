#!/usr/bin/env python
"""Reproduce the README accuracy table: dense-cloud ADD-S of full tracking
over synthetic VGA T42 grasp sequences (exact GT), clean and noisy.

    python scripts/eval_accuracy.py [--frames 8] [--shape ellipsoid]
        [--particles 512] [--no-subpixel] [--noise clean|noisy|both]

Noisy = 1 mm depth sigma + 2% dropout (the BASELINE-table condition).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from icra20_hand_object_pose_tpu.utils.jaxcache import enable_compilation_cache  # noqa: E402
enable_compilation_cache()


def run(shape: str, noise: bool, subpixel: bool, frames: int,
        particles: int, init_gt: bool = False, n_hyp: int = 1,
        motion_prior: float | None = None,
        tau_fine: float | None = None, seed: int = 3,
        realistic: bool = False,
        joint_sigma: float | None = None,
        finisher: str | None = None,
        base_refine: int = -1,
        self_occ: bool = True) -> dict:
    import jax
    import jax.numpy as jnp
    from icra20_hand_object_pose_tpu.datasets import (
        SyntheticSequenceConfig, generate_sequence,
    )
    from icra20_hand_object_pose_tpu.evaluation import add_s_error
    from icra20_hand_object_pose_tpu.models import (
        Estimator, ObjectModel, Tracker, make_t42_hand,
    )
    from icra20_hand_object_pose_tpu.utils import meshio
    from icra20_hand_object_pose_tpu.utils.config import (
        CameraIntrinsics, EstimatorConfig, PsoConfig, ScoreConfig,
    )

    cam = CameraIntrinsics(width=640, height=480, fx=570.0, fy=570.0,
                           cx=320.0, cy=240.0)
    from icra20_hand_object_pose_tpu.utils.config import TrackerConfig

    score_kw = dict(subpixel=subpixel, self_occlusion=self_occ)
    if tau_fine is not None:
        score_kw["depth_tau_fine"] = tau_fine
    tracker_kw = dict(n_hypotheses=n_hyp)
    if motion_prior is not None:
        tracker_kw["motion_prior"] = motion_prior
    hand_kw = {}
    if joint_sigma is not None or (realistic and base_refine != 0):
        from icra20_hand_object_pose_tpu.utils.config import HandConfig
        hkw = {}
        if joint_sigma is not None:
            hkw["joint_sigma"] = joint_sigma
        if realistic and base_refine != 0:
            # calibration error regime -> hand-mount base search on
            # (3 rounds default; --base-refine 0 disables for A/B)
            hkw["base_refine_iters"] = base_refine if base_refine > 0 else 3
        hand_kw["hand"] = HandConfig(**hkw)
    pso_kw = dict(particles=particles, iters=10)
    if finisher:
        fi, fp, fr = (int(x) for x in finisher.split(","))
        pso_kw.update(finish_iters=fi, finish_particles=fp,
                      finish_sigma_rungs=fr)
    cfg = EstimatorConfig(
        camera=cam, scene_points=2048,
        pso=PsoConfig(**pso_kw),
        score=ScoreConfig(**score_kw),
        tracker=TrackerConfig(**tracker_kw),
        **hand_kw,
    )
    mesh = meshio.make_test_object(shape)
    hand = make_t42_hand()
    if realistic:
        # VERDICT r3 item 3: full sensor model (1 mm quantization, z^2
        # noise, lateral edge jitter) + hand CALIBRATION error (base
        # ±5 mm/±3 deg, nominal q 0.15 rad off the true closure)
        from icra20_hand_object_pose_tpu.datasets import SensorModel
        seq_cfg = SyntheticSequenceConfig(
            n_frames=frames, camera=cam,
            sensor=SensorModel(noise_sigma=0.001 if noise else 0.0,
                               dropout=0.02 if noise else 0.0),
            hand_base_err_mm=5.0, hand_base_err_deg=3.0,
            hand_q_true_offset=0.15,
            seed=seed,
        )
    else:
        seq_cfg = SyntheticSequenceConfig(
            n_frames=frames, camera=cam,
            noise_sigma=0.001 if noise else 0.0,
            dropout=0.02 if noise else 0.0,
            seed=seed,
        )
    from icra20_hand_object_pose_tpu.evaluation import (
        add_error, add_sym_error, rotation_error_deg, symmetry_group,
        translation_error,
    )
    try:
        sym_group = symmetry_group(shape)
    except ValueError:
        sym_group = None

    frs = generate_sequence(mesh, hand, seq_cfg)
    sym_errs = []
    tracker = Tracker(Estimator(ObjectModel(mesh), hand, cfg), seed=0)
    if init_gt:
        # standard tracking protocol: the first pose is given (as in the
        # reference's recorded sequences); isolates tracking accuracy
        # from single-frame global-init ambiguity
        tracker.state = tracker.state._replace(
            pose=jnp.asarray(frs[0].pose_gt),
            initialized=jnp.asarray(True),
            fitness=jnp.asarray(1.0),
        )
    dense, _ = mesh.sample_surface(8192, seed=123)
    errs, adds, rots, trs = [], [], [], []
    t0 = time.perf_counter()
    for fr in frs:
        out = tracker.step(
            jnp.asarray(fr.depth), jnp.asarray(fr.hand_base),
            jnp.asarray(fr.hand_q),
        )
        P = np.asarray(out.pose)
        errs.append(add_s_error(P, fr.pose_gt, dense))
        if sym_group is not None:
            sym_errs.append(add_sym_error(P, fr.pose_gt, dense, sym_group))
        adds.append(add_error(P, fr.pose_gt, dense))
        rots.append(rotation_error_deg(P, fr.pose_gt))
        trs.append(translation_error(P, fr.pose_gt))
    dt = time.perf_counter() - t0
    rec = dict(
        shape=shape, noise=noise, subpixel=subpixel, frames=frames,
        init_gt=init_gt, n_hyp=n_hyp, realistic=realistic,
        adds_mm=[round(e * 1000, 3) for e in errs],
        adds_mm_mean=round(float(np.mean(errs)) * 1000, 3),
        adds_mm_tracked_mean=round(float(np.mean(errs[1:])) * 1000, 3),
        # NOTE: sampled-cloud ADD-S floors at ~half the sample spacing
        # (~0.9 mm @8192 pts) when the estimate is a symmetry flip; ADD /
        # rot / trans are floor-free but only meaningful on 'asym'.
        add_mm_mean=round(float(np.mean(adds)) * 1000, 3),
        # symmetry-aware ADD: exact even when the estimate is a symmetry
        # flip (where ADD-S floors and plain ADD explodes)
        sym_add_mm_mean=(round(float(np.mean(sym_errs)) * 1000, 3)
                         if sym_errs else None),
        rot_deg_mean=round(float(np.mean(rots)), 3),
        trans_mm_mean=round(float(np.mean(trs)) * 1000, 3),
        s_total=round(dt, 1),
    )
    print(json.dumps(rec), flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--shape", default="ellipsoid")
    ap.add_argument("--particles", type=int, default=512)
    ap.add_argument("--no-subpixel", action="store_true")
    ap.add_argument("--init-gt", action="store_true",
                    help="first pose given (standard tracking protocol)")
    ap.add_argument("--hyp", type=int, default=1,
                    help="tracker hypotheses (competing basins)")
    ap.add_argument("--noise", default="both", choices=["clean", "noisy", "both"])
    ap.add_argument("--motion-prior", type=float, default=None,
                    help="override TrackerConfig.motion_prior (A/B)")
    ap.add_argument("--tau-fine", type=float, default=None,
                    help="override ScoreConfig.depth_tau_fine (A/B; 0=off)")
    ap.add_argument("--seed", type=int, default=3, help="sequence seed")
    ap.add_argument("--realistic", action="store_true",
                    help="full sensor model + hand calibration error "
                         "(VERDICT r3 item 3)")
    ap.add_argument("--joint-sigma", type=float, default=None,
                    help="override HandConfig.joint_sigma (A/B)")
    ap.add_argument("--finisher", default=None,
                    help="override finisher shape as iters,particles,rungs")
    ap.add_argument("--base-refine", type=int, default=-1,
                    help="hand-base refine rounds in --realistic mode "
                         "(-1 = auto 3, 0 = off for A/B)")
    ap.add_argument("--no-self-occ", action="store_true",
                    help="disable ScoreConfig.self_occlusion (A/B)")
    a = ap.parse_args()
    noises = {"clean": [False], "noisy": [True], "both": [False, True]}[a.noise]
    for n in noises:
        run(a.shape, n, not a.no_subpixel, a.frames, a.particles, a.init_gt,
            a.hyp, a.motion_prior, a.tau_fine, a.seed, a.realistic,
            a.joint_sigma, a.finisher, a.base_refine,
            not a.no_self_occ)


if __name__ == "__main__":
    main()
