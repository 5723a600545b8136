#!/usr/bin/env python
"""Per-phase wall-time breakdown of the frame program on the local chip
(VERDICT r1 item 4: find the bottleneck before optimizing).

The frame is ONE jit program, so phases are isolated by compiling
ablated variants and differencing (timers that wait for the device,
utils/profiling.PhaseTimer):

    hand     = jit(_hand_tensors) alone       (VGA hand splat + FK)
    pre      = jit(preprocess_frame) alone
    no_scan  = frame with pso_iters=0, finish_iters=0  -> fixed costs
    no_fin   = frame with finish_iters=0               -> + PSO scan
    full     = production frame                        -> + finisher
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from icra20_hand_object_pose_tpu.utils.jaxcache import enable_compilation_cache  # noqa: E402
enable_compilation_cache()


def main():
    import jax
    import jax.numpy as jnp
    from icra20_hand_object_pose_tpu.datasets import (
        default_object_pose, hand_base_for_grasp, render_frame_fast,
    )
    from icra20_hand_object_pose_tpu.models import (
        Estimator, ObjectModel, make_t42_hand,
    )
    from icra20_hand_object_pose_tpu.utils import meshio
    from icra20_hand_object_pose_tpu.utils.config import (
        CameraIntrinsics, EstimatorConfig, PsoConfig,
    )

    cam = CameraIntrinsics(width=640, height=480, fx=570.0, fy=570.0,
                           cx=320.0, cy=240.0)
    base_pso = PsoConfig(particles=512, iters=10)
    mesh = meshio.make_test_object("box")
    hand = make_t42_hand()
    obj = ObjectModel(mesh, model_points=1024, render_points=2048)
    pose_gt = default_object_pose()
    hb = hand_base_for_grasp(pose_gt)
    hq = np.asarray([0.45, 0.45], np.float32)
    depth = jnp.asarray(render_frame_fast(
        mesh, pose_gt, hand, hb, hq, cam, noise_sigma=0.001))
    prev = jnp.asarray(pose_gt)
    hbj, hqj = jnp.asarray(hb), jnp.asarray(hq)

    n_rep = 8

    def timed(fn, *args, **kw):
        out = fn(*args, **kw)                    # compile+warm
        np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[:1]
        t0 = time.perf_counter()
        for _ in range(n_rep):
            out = fn(*args, **kw)
        np.asarray(jax.tree_util.tree_leaves(out)[0]).ravel()[:1]
        return (time.perf_counter() - t0) / n_rep * 1000.0  # ms

    results = {}

    def est_for(pso_cfg):
        cfg = EstimatorConfig(camera=cam, scene_points=2048, pso=pso_cfg)
        return Estimator(obj, hand, cfg)

    est = est_for(base_pso)

    # isolated sub-programs
    hand_jit = jax.jit(est._hand_tensors)
    results["hand_tensors"] = timed(
        hand_jit, jax.random.key(0), hbj, hqj, depth)

    from icra20_hand_object_pose_tpu.ops import preprocess
    pre_jit = jax.jit(lambda k, d: preprocess.preprocess_frame(
        k, d, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
        depth_min=0.1, depth_max=2.0, n_points=2048,
        render_factor=est.render_factor))
    results["preprocess"] = timed(pre_jit, jax.random.key(1), depth)

    # ablated full frames
    def run_frame(e):
        def f(seed):
            return e.estimate(depth, prev, hbj, hqj,
                              key=jax.random.key(seed), mode="track")
        return timed(f, 0)

    t_noscan = run_frame(est_for(dataclasses.replace(
        base_pso, iters=1, finish_iters=0)))
    t_nofin = run_frame(est_for(dataclasses.replace(base_pso, finish_iters=0)))
    t_full = run_frame(est)
    results["frame_fixed+1iter (no scan, no finisher)"] = t_noscan
    results["pso_scan_9iters"] = t_nofin - t_noscan
    results["finisher"] = t_full - t_nofin
    results["frame_total"] = t_full
    print(json.dumps({k: round(v, 1) for k, v in results.items()}, indent=1))


if __name__ == "__main__":
    main()
