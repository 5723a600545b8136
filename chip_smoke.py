#!/usr/bin/env python
"""On-card smoke test: the tracker end to end on one NVIDIA GPU.

    python chip_smoke.py           # phases (a) device, (b) parity, (c) tracking
    python chip_smoke.py --four    # (a) device, then (d) only: the 4-card
                                   # library sweep and particle sharding,
                                   # each against the same work on one card

(a) device: refuses to run unless JAX's backend is a GPU.
(b) parity: the correspondence search at the in-scan, init and polish
    widths against a float64 brute force, and the one-hot-matmul image
    lookups (gather_mode="mxu") against plain gathers ("take") on a
    full-width frame.
(c) tracking: the public API — Tracker(Estimator(ObjectModel(mesh),
    make_t42_hand(), cfg)).step(depth, hand_base, hand_q) — at the
    benchmark configuration (VGA, 512 particles, 10 PSO iterations, 2048
    scene / 1024 model / 2048 render points, default init program) on an
    exact-raster grasp sequence of the asymmetric object with 1 mm noise.
    Frame 0 is a global registration with no prior. ADD-S is checked on
    every frame against the accuracy gates of
    tests/test_accuracy_regression.py.

Every number is printed beside the card's name and power limit. Any
failed phase raises, so the exit code is non-zero; on success the last
line is exactly {"ok": true, "device": {"platform", "kind", "count"}}.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# tests/test_accuracy_regression.py gates (asym, noisy), meters
MEAN_TRACKED_ADDS = 2.4e-3
WORST_FRAME_ADDS = 8e-3
# frame 0 is the global init; frames 1-8 warm up, 9-29 are the steady window
N_FRAMES = 30
# correspondence-search widths [P, Ns, Nm] of the benchmark configuration
NN_SHAPES = {
    "in-scan": (512, 512, 256),
    "init": (1024, 512, 512),
    "polish": (18, 2048, 1024),
}


def select_phases(four: bool) -> tuple[str, ...]:
    return ("device", "four") if four else ("device", "parity", "tracking")


def result_line(dev: dict) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}})


def card_line() -> str:
    """`name, power limit` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return " | ".join(sorted(set(out.splitlines())))


def say(card: str, msg: str) -> None:
    print(f"[{card}] {msg}", flush=True)


# -- (a) device ----------------------------------------------------------


def phase_device() -> tuple[dict, str]:
    import jax

    from icra20_hand_object_pose_tpu.benchmarks import require_gpu

    dev = require_gpu()
    card = card_line()
    print(f"card: {card}", flush=True)
    say(card, f"jax {jax.__version__}, platform {dev['platform']}, "
              f"device_kind {dev['kind']!r}, {dev['count']} device(s)")
    return dev, card


# -- (b) parity ----------------------------------------------------------


def _check_nn(name, out, q, r, n):
    """Check (matched, mnormal, d2, idx) against a float64 brute force.

    Tolerance: the search is exact f32 diff-square-accumulate (no matmul,
    so no TF32); f32 rounding of d2 is ~1e-7 relative, so d2 must match
    the float64 distance of the chosen point to rtol 1e-5, and the chosen
    point must be a float64 nearest neighbor to the same tolerance (a
    near-tie may pick either). Matched points and normals are gathers:
    bitwise equal to ref[idx]."""
    matched, mnormal, d2, idx = (np.asarray(a) for a in out)
    q64 = np.broadcast_to(np.asarray(q, np.float64),
                          (r.shape[0],) + q.shape[-2:])
    r64 = np.asarray(r, np.float64)
    for p in range(0, r.shape[0], max(1, r.shape[0] // 4)):
        full = ((q64[p][:, None, :] - r64[p][None]) ** 2).sum(-1)
        best = full.min(-1)
        chosen = full[np.arange(full.shape[0]), idx[p]]
        np.testing.assert_allclose(d2[p], chosen, rtol=1e-5, atol=1e-12,
                                   err_msg=f"{name}: d2")
        np.testing.assert_allclose(chosen, best, rtol=1e-5, atol=1e-12,
                                   err_msg=f"{name}: not a nearest point")
        np.testing.assert_array_equal(matched[p], np.asarray(r)[p][idx[p]])
        np.testing.assert_array_equal(mnormal[p], np.asarray(n)[p][idx[p]])


def nn_parity(card: str) -> None:
    import jax
    import jax.numpy as jnp

    from icra20_hand_object_pose_tpu.ops import knn

    search = jax.jit(knn.nn_gather_batched)
    for name, (P, Ns, Nm) in NN_SHAPES.items():
        kq, kr, kn = jax.random.split(jax.random.key(Ns + Nm), 3)
        centre = jnp.asarray([0.0, 0.0, 0.5])
        q = centre + jax.random.uniform(kq, (Ns, 3), minval=-0.06,
                                        maxval=0.06)
        r = centre + jax.random.uniform(kr, (P, Nm, 3), minval=-0.06,
                                        maxval=0.06)
        n = jax.random.normal(kn, (P, Nm, 3))
        out = jax.block_until_ready(search(q, r, n))
        _check_nn(f"xla {name}", out, q, r, n)
        say(card, f"parity nn {name} [P={P}, Ns={Ns}, Nm={Nm}] xla fused "
                  "search vs float64 brute force: ok (f32 diff-square, "
                  "no matmul; d2 rtol 1e-5, gathers bitwise)")


def gather_parity(card: str, est, frame) -> None:
    """gather_mode="mxu" against "take" on one full-width frame.

    1. Lookups: the one-hot matmuls must return exactly f32(hi) + f32(lo)
       of the double-bf16 tables — bitwise. The operands are 0/1 and bf16
       halves, all exactly representable in TF32, so the card's DEFAULT
       (TF32) f32 matmul loses nothing. Checked for the whole-image
       tables (coarse tier) and the per-sample patch tables (finisher).
    2. Scores: the same 512 poses scored both ways. The tables carry ~16
       mantissa bits (~8 um at 0.5 m), so a sample sitting on a depth
       threshold can flip class, and at the fine tier a sample that
       leaves its 16x16 patch reads "no evidence" by design: scores
       agree to that noise, not bitwise (mean |d fitness| <= 1e-3, 99th
       percentile <= 0.02; the max is reported)."""
    import jax
    import jax.numpy as jnp

    from icra20_hand_object_pose_tpu.ops import gather_mxu, pso, score
    from icra20_hand_object_pose_tpu.utils import se3

    cfg = est.cfg
    obj = est.obj
    cam = cfg.camera
    sc = cfg.score
    kr = cfg.pso.scan_render_subset
    S = cfg.pso.finish_patch
    k1, k2, k3, k4 = jax.random.split(jax.random.key(11), 4)
    scene, _, hd_lo, hd_hi, _ = jax.jit(est._scene_prep)(
        k1, k2, jnp.asarray(frame.depth), jnp.asarray(frame.hand_base),
        jnp.asarray(frame.hand_q))
    gt = jnp.asarray(frame.pose_gt)
    enc_lo = score.encode_observed(scene.depth, scene.valid, sc.ghost_dilate,
                                   neutral=scene.neutral)
    enc_hi = score.encode_observed(scene.depth_full, scene.valid_full,
                                   sc.ghost_dilate, neutral=scene.neutral_full)
    far = lambda hd: jnp.where(jnp.isfinite(hd), hd, score._FAR)
    ref = se3.transform_points(gt, obj.render_pts)
    zr = jnp.maximum(ref[..., 2], 1e-6)
    pu0 = jnp.clip(jnp.round(ref[..., 0] / zr * cam.fx + cam.cx)
                   .astype(jnp.int32) - S // 2, 0, cam.width - S)
    pv0 = jnp.clip(jnp.round(ref[..., 1] / zr * cam.fy + cam.cy)
                   .astype(jnp.int32) - S // 2, 0, cam.height - S)
    img_tables = ("image", *gather_mxu.split_bf16(enc_lo),
                  *gather_mxu.split_bf16(far(hd_lo)))
    patch_tables = ("patch",
                    *gather_mxu.split_bf16(
                        gather_mxu.extract_patches(enc_hi, pv0, pu0, S)),
                    *gather_mxu.split_bf16(
                        gather_mxu.extract_patches(far(hd_hi), pv0, pu0, S)),
                    pv0, pu0)

    # 1. lookups, bitwise
    hi, lo = img_tables[1], img_tables[2]
    vi = jax.random.randint(k3, (512, kr), 0, est.lo_h)
    ui = jax.random.randint(k4, (512, kr), 0, est.lo_w)
    got = jax.jit(gather_mxu.take_image)(hi, lo, vi, ui)
    want = hi.astype(jnp.float32)[vi, ui] + lo.astype(jnp.float32)[vi, ui]
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg="take_image")
    p_hi, p_lo = patch_tables[1], patch_tables[2]
    n = p_hi.shape[0]
    lv = jax.random.randint(k3, (64, n), 0, S)
    lu = jax.random.randint(k4, (64, n), 0, S)
    got = jax.jit(gather_mxu.take_patches)(p_hi, p_lo, lv, lu)
    rows = jnp.arange(n)[None]
    want = (p_hi.astype(jnp.float32)[rows, lv, lu]
            + p_lo.astype(jnp.float32)[rows, lv, lu])
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg="take_patches")
    say(card, f"parity gather_mode mxu lookups: take_image [512x{kr}] over "
              f"{est.lo_w}x{est.lo_h} and take_patches [64x{n}] {S}x{S} "
              "patches bitwise equal to the double-bf16 tables (f32 "
              "operands at DEFAULT precision: TF32 is exact for them)")

    # 2. scores
    poses = se3.perturb_pose(k3, gt, 0.05, 0.01, shape=(512,))
    fine = se3.perturb_pose(k4, gt, 0.005, 0.002, shape=(512,))

    @jax.jit
    def both():
        lo_kw = dict(fx=est.lo_fx, fy=est.lo_fy, cx=est.lo_cx, cy=est.lo_cy,
                     height=est.lo_h, width=est.lo_w, splat_radius=1,
                     score_cfg=sc, observed_enc=enc_lo)
        hi_kw = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                     height=cam.height, width=cam.width, splat_radius=1,
                     score_cfg=sc, subpixel=sc.subpixel, observed_enc=enc_hi)
        lo_args = (poses, obj.render_pts[:kr], obj.render_normals[:kr],
                   obj.render_w[:kr], scene.depth, scene.valid, hd_lo)
        hi_args = (fine, obj.render_pts, obj.render_normals, obj.render_w,
                   scene.depth_full, scene.valid_full, hd_hi)
        return (pso.score_particles(*lo_args, mxu_tables=img_tables, **lo_kw),
                pso.score_particles(*lo_args, **lo_kw),
                pso.score_particles(*hi_args, mxu_tables=patch_tables,
                                    **hi_kw),
                pso.score_particles(*hi_args, **hi_kw))

    lo_m, lo_t, hi_m, hi_t = both()
    for tier, (fm, _), (ft, _) in (("coarse tier, image tables", lo_m, lo_t),
                                   ("fine tier, patch tables", hi_m, hi_t)):
        d = np.abs(np.asarray(fm) - np.asarray(ft))
        p99 = float(np.percentile(d, 99))
        say(card, f"parity gather_mode mxu vs take, {tier}, 512 poses: "
                  f"mean |d fitness| {d.mean():.3g}, p99 {p99:.3g}, max "
                  f"{d.max():.3g} (tolerance mean 1e-3, p99 0.02)")
        if d.mean() > 1e-3 or p99 > 0.02:
            raise AssertionError(f"gather modes disagree at the {tier}")


# -- (c) tracking --------------------------------------------------------


def benchmark_setup(shape: str = "asym"):
    """(mesh, hand, cfg) at the benchmark configuration (bench.py)."""
    from icra20_hand_object_pose_tpu.models import make_t42_hand
    from icra20_hand_object_pose_tpu.utils import meshio
    from icra20_hand_object_pose_tpu.utils.config import (
        CameraIntrinsics, EstimatorConfig, PsoConfig,
    )

    cam = CameraIntrinsics(width=640, height=480, fx=570.0, fy=570.0,
                           cx=320.0, cy=240.0)
    cfg = EstimatorConfig(camera=cam, scene_points=2048,
                          pso=PsoConfig(particles=512, iters=10))
    return meshio.make_test_object(shape), make_t42_hand(), cfg


def phase_tracking(card: str, seed: int, n_frames: int, steady_from: int):
    import jax
    import jax.numpy as jnp

    from icra20_hand_object_pose_tpu.datasets import (
        SyntheticSequenceConfig, generate_sequence,
    )
    from icra20_hand_object_pose_tpu.evaluation import add_s_error
    from icra20_hand_object_pose_tpu.models import (
        Estimator, ObjectModel, Tracker,
    )

    mesh, hand, cfg = benchmark_setup("asym")
    est = Estimator(ObjectModel(mesh, model_points=1024, render_points=2048),
                    hand, cfg)
    t0 = time.perf_counter()
    seq = generate_sequence(mesh, hand, SyntheticSequenceConfig(
        n_frames=n_frames, camera=cfg.camera, noise_sigma=0.001,
        dropout=0.02, seed=seed))
    say(card, f"sequence: {n_frames} exact-raster {cfg.camera.width}x"
              f"{cfg.camera.height} frames, asym, 1 mm "
              f"noise, seed {seed}, generated in "
              f"{time.perf_counter() - t0:.1f} s")
    gather_parity(card, est, seq[0])

    dense, _ = mesh.sample_surface(8192, seed=123)
    tracker = Tracker(est, seed=0)
    errs, step_ms, reinit = [], [], []
    for i, fr in enumerate(seq):
        depth = jnp.asarray(fr.depth)
        hb = jnp.asarray(fr.hand_base)
        hq = jnp.asarray(fr.hand_q)
        t = time.perf_counter()
        out = tracker.step(depth, hb, hq)
        out.pose.block_until_ready()
        step_ms.append((time.perf_counter() - t) * 1e3)
        errs.append(add_s_error(np.asarray(out.pose), fr.pose_gt, dense))
        reinit.append(bool(out.reinitialized))
        if i < 2:
            say(card, f"frame {i} ({'init' if i == 0 else 'track'} program)"
                      f" first call incl. compile: {step_ms[-1] / 1e3:.1f} s")
    steady = np.asarray(step_ms[steady_from:])
    say(card, f"Tracker.step steady window frames {steady_from}-"
              f"{n_frames - 1} (n={steady.size}): median "
              f"{np.median(steady):.2f} ms/frame, p90 "
              f"{np.percentile(steady, 90):.2f} ms/frame")

    # device frame-program time: the compiled track program alone
    fr = seq[-1]
    args = (jnp.asarray(fr.depth), jnp.asarray(fr.pose_gt),
            jnp.asarray(fr.hand_base), jnp.asarray(fr.hand_q))
    est.estimate(*args, key=jax.random.key(0)).pose.block_until_ready()
    prog_ms = []
    for k in range(20):
        t = time.perf_counter()
        est.estimate(*args, key=jax.random.key(k)).pose.block_until_ready()
        prog_ms.append((time.perf_counter() - t) * 1e3)
    say(card, f"track frame program (Estimator.estimate, 20 calls): median "
              f"{np.median(prog_ms):.2f} ms, p90 "
              f"{np.percentile(prog_ms, 90):.2f} ms")

    mm = [round(e * 1e3, 2) for e in errs]
    tracked = [e for e, r in zip(errs, reinit) if not r]
    mean_tr = float(np.mean(tracked)) if tracked else float("inf")
    say(card, f"ADD-S per frame (mm): {mm}")
    say(card, f"ADD-S: init frame {mm[0]} mm, mean tracked "
              f"{mean_tr * 1e3:.3f} mm over {len(tracked)} frames "
              f"(gate {MEAN_TRACKED_ADDS * 1e3} mm), worst "
              f"{max(mm)} mm (gate {WORST_FRAME_ADDS * 1e3} mm), "
              f"re-inits after frame 0: {sum(reinit[1:])}")
    if not reinit[0] or len(tracked) < 8:
        raise AssertionError(f"expected init at frame 0 then >= 8 tracked "
                             f"frames, got reinit flags {reinit}")
    if mean_tr >= MEAN_TRACKED_ADDS or max(errs) >= WORST_FRAME_ADDS:
        raise AssertionError(f"accuracy gate failed: per-frame mm {mm}")


# -- (d) four cards ------------------------------------------------------


def phase_four(card: str, n_dev: int = 4, cfg=None, hand=None,
               n_objects: int = 8):
    """The object-sharded library sweep and the particle-sharded frame
    program on an n_dev mesh, each against the same work on one device.

    The sweep starts initialized at ground truth, so both runs take
    track-program steps (three; the third is timed). Object sharding
    changes no per-object algorithm, but XLA fuses the two programs
    differently and the last-bit differences move near-tied argmaxes, so
    the swarms diverge chaotically within the basin. Particle sharding
    draws each shard's swarm from its own key. So each run is an
    independent estimate: every pose must stay in the true basin (ADD-S
    below the tier-1 tracking-loss gate, 8 mm, against truth on these
    splat-rendered frames, whose surface sits up to ~1 mm toward the
    camera), and each sharded pose must agree with its one-device twin to
    4 mm ADD-S, twice the ~2 mm per-frame spread the tracker shows here.
    A wrong sharding rule shows as tens of millimetres or NaN. ADD-S, not
    ADD, because the library holds symmetric shapes (the cylinder spins
    freely about its axis)."""
    import jax
    import jax.numpy as jnp

    from icra20_hand_object_pose_tpu.datasets import (
        default_object_pose, hand_base_for_grasp, render_frame_fast,
    )
    from icra20_hand_object_pose_tpu.evaluation import add_s_error
    from icra20_hand_object_pose_tpu.models import Estimator, ObjectModel
    from icra20_hand_object_pose_tpu.parallel import LibrarySweep, make_mesh
    from icra20_hand_object_pose_tpu.utils import meshio

    if len(jax.devices()) < n_dev:
        raise RuntimeError(f"--four needs {n_dev} devices, JAX sees "
                           f"{len(jax.devices())}")
    if cfg is None:
        _, hand, cfg = benchmark_setup()
    cam = cfg.camera
    shapes = ["asym", "box", "cylinder", "sphere", "ellipsoid", "lbracket",
              "tee", "mug"][:n_objects]
    meshes = [meshio.make_test_object(s) for s in shapes]
    objs = [ObjectModel(m, model_points=cfg.model_points,
                        render_points=2 * cfg.model_points, seed=i)
            for i, m in enumerate(meshes)]
    gt = default_object_pose()
    hb = hand_base_for_grasp(gt)
    hq = np.asarray([0.45, 0.45], np.float32)
    depths = jnp.asarray(np.stack([
        render_frame_fast(m, gt, hand, hb, hq, cam, noise_sigma=0.001)
        for m in meshes]))
    hbs = jnp.tile(jnp.asarray(hb)[None], (len(objs), 1, 1))
    hqs = jnp.tile(jnp.asarray(hq)[None], (len(objs), 1))
    dense = [m.sample_surface(4096, seed=123)[0] for m in meshes]

    def sweep_poses(mesh):
        sweep = LibrarySweep(objs, hand, cfg, mesh=mesh, axis_name="obj")
        st = sweep.init_state(seed=0)
        st = st._replace(
            poses=jnp.tile(jnp.asarray(gt)[None], (len(objs), 1, 1)),
            initialized=jnp.ones((len(objs),), bool),
            fitness=jnp.ones((len(objs),)),
            pose_tracked=jnp.ones((len(objs),), bool))
        ms = []
        for _ in range(3):
            t = time.perf_counter()
            st, res = sweep.step(st, depths, hbs, hqs)
            res.poses.block_until_ready()
            ms.append((time.perf_counter() - t) * 1e3)
        return np.asarray(res.poses), ms

    p4, ms4 = sweep_poses(make_mesh(n_dev, "obj"))
    p1, ms1 = sweep_poses(None)
    mm = lambda xs: [round(x * 1e3, 2) for x in xs]
    gaps = [add_s_error(a, b, d) for a, b, d in zip(p4, p1, dense)]
    errs4 = [add_s_error(p, gt, d) for p, d in zip(p4, dense)]
    errs1 = [add_s_error(p, gt, d) for p, d in zip(p1, dense)]
    say(card, f"sweep {len(objs)} objects x {cfg.pso.particles} particles, "
              f"track program, ms per step (first incl. compile): "
              f"{n_dev}-device mesh {[round(x, 1) for x in ms4]}, one "
              f"device {[round(x, 1) for x in ms1]}")
    say(card, f"sweep ADD-S {n_dev}-device vs one device per object (mm): "
              f"{mm(gaps)} (tolerance 4 mm); vs truth {mm(errs4)} / "
              f"{mm(errs1)} (tolerance 8 mm)")
    if max(gaps) > 4e-3 or max(errs4 + errs1) >= WORST_FRAME_ADDS:
        raise AssertionError("sharded sweep disagrees")

    obj = objs[0]
    args = (depths[0], jnp.asarray(gt), hbs[0], hqs[0])
    out = {}
    for label, mesh in (("sharded", make_mesh(n_dev, "p")), ("one", None)):
        est = Estimator(obj, hand, cfg, mesh=mesh, axis_name="p")
        t = time.perf_counter()
        est.estimate(*args, key=jax.random.key(1)).pose.block_until_ready()
        first = time.perf_counter() - t
        t = time.perf_counter()
        res = est.estimate(*args, key=jax.random.key(2))
        res.pose.block_until_ready()
        out[label] = (np.asarray(res.pose), first, time.perf_counter() - t)
    e_sh = add_s_error(out["sharded"][0], gt, dense[0])
    e_one = add_s_error(out["one"][0], gt, dense[0])
    gap = add_s_error(out["sharded"][0], out["one"][0], dense[0])
    say(card, f"particle-sharded estimate {cfg.pso.particles} particles over "
              f"{n_dev} devices: {out['sharded'][2] * 1e3:.1f} ms (first "
              f"{out['sharded'][1]:.1f} s), one device "
              f"{out['one'][2] * 1e3:.1f} ms (first {out['one'][1]:.1f} s)")
    say(card, f"particle-sharded vs one device: ADD-S {gap * 1e3:.3f} mm "
              f"(tolerance 4 mm), ADD-S vs truth {e_sh * 1e3:.3f} / "
              f"{e_one * 1e3:.3f} mm (tolerance 8 mm)")
    if gap > 4e-3 or max(e_sh, e_one) >= WORST_FRAME_ADDS:
        raise AssertionError("particle-sharded estimate disagrees")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sweep / particle-sharding "
                         "phase against one card")
    ap.add_argument("--seed", type=int, default=3,
                    help="seed of the synthetic sequence (3: the seed of "
                         "tests/test_accuracy_regression.py)")
    a = ap.parse_args(argv)

    from icra20_hand_object_pose_tpu.utils.jaxcache import (
        enable_compilation_cache,
    )

    dev, card = phase_device()
    enable_compilation_cache()
    phases = select_phases(a.four)
    if "parity" in phases:
        nn_parity(card)
    if "tracking" in phases:
        phase_tracking(card, a.seed, N_FRAMES, steady_from=N_FRAMES - 21)
    if "four" in phases:
        phase_four(card)
    print(result_line(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
