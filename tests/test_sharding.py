"""Multi-chip behavior on the virtual 8-device CPU mesh (SURVEY.md §5.5).

Covers BASELINE config 5 (library sweep) and the particle-axis
shard_map path, plus the graft entry points the driver exercises.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icra20_hand_object_pose_tpu.datasets import (
    SyntheticSequenceConfig, generate_sequence,
)
from icra20_hand_object_pose_tpu.models import Estimator, ObjectModel, make_t42_hand
from icra20_hand_object_pose_tpu.parallel import LibrarySweep, make_mesh
from icra20_hand_object_pose_tpu.utils import meshio, se3
from icra20_hand_object_pose_tpu.utils.config import (
    CameraIntrinsics, EstimatorConfig, PsoConfig, TrackerConfig,
)


@pytest.fixture(scope="module")
def tiny():
    cam = CameraIntrinsics(width=64, height=48, fx=58.0, fy=58.0, cx=32.0, cy=24.0)
    cfg = EstimatorConfig(
        camera=cam, scene_points=256, render_size=48,
        pso=PsoConfig(particles=16, iters=3, icp_iters_inner=2),
        tracker=TrackerConfig(reinit_particles=16, reinit_prescreen=64),
    )
    mesh = meshio.make_test_object("box")
    hand = make_t42_hand(points_per_link=64)
    obj = ObjectModel(mesh, model_points=256, render_points=512)
    frame = generate_sequence(
        mesh, hand, SyntheticSequenceConfig(n_frames=1, camera=cam,
                                            noise_sigma=0.0, dropout=0.0),
    )[0]
    return cfg, obj, hand, frame


def test_particle_sharded_matches_quality(tiny):
    """Sharded estimate must produce a finite, GT-consistent pose."""
    cfg, obj, hand, frame = tiny
    mesh8 = make_mesh(8, "p")
    est = Estimator(obj, hand, cfg, mesh=mesh8, axis_name="p")
    out = est.estimate(
        jnp.asarray(frame.depth), jnp.asarray(frame.pose_gt),
        jnp.asarray(frame.hand_base), jnp.asarray(frame.hand_q),
        mode="track",
    )
    adds = se3.add_s_error(
        out.pose, jnp.asarray(frame.pose_gt), obj.model_pts
    )
    assert np.isfinite(float(out.fitness))
    # measured 4.4 mm at this tiny resolution/swarm (deterministic key);
    # 8 mm = 2x margin (VERDICT r3 weak #8 called the old 2 cm toothless)
    assert float(adds) < 0.008, f"ADD-S {float(adds)*1000:.2f}mm"


def test_particle_sharding_requires_divisibility(tiny):
    cfg, obj, hand, frame = tiny
    import dataclasses
    bad = dataclasses.replace(cfg, pso=dataclasses.replace(cfg.pso, particles=13))
    est = Estimator(obj, hand, bad, mesh=make_mesh(8, "p"))
    with pytest.raises(ValueError, match="divisible"):
        est.estimate(
            jnp.asarray(frame.depth), jnp.asarray(frame.pose_gt),
            jnp.asarray(frame.hand_base), jnp.asarray(frame.hand_q),
        )


def test_library_sweep_sharded(tiny):
    """8 objects concurrently over an 8-device mesh: per-object poses,
    device-side re-init decision, checkpoint round-trip."""
    cfg, obj, hand, frame = tiny
    objs = [
        ObjectModel(meshio.make_test_object("box"), model_points=256,
                    render_points=512, seed=i)
        for i in range(8)
    ]
    sweep = LibrarySweep(objs, hand, cfg, mesh=make_mesh(8, "obj"),
                         axis_name="obj")
    st = sweep.init_state()
    depths = jnp.tile(jnp.asarray(frame.depth)[None], (8, 1, 1))
    hbs = jnp.tile(jnp.asarray(frame.hand_base)[None], (8, 1, 1))
    hqs = jnp.tile(jnp.asarray(frame.hand_q)[None], (8, 1))
    st, res = sweep.step(st, depths, hbs, hqs)
    assert res.poses.shape == (8, 4, 4)
    assert bool(jnp.all(res.reinitialized))  # first frame: all init
    st2, res2 = sweep.step(st, depths, hbs, hqs)
    assert res2.poses.shape == (8, 4, 4)
    # second frame: tracked objects with healthy fitness must not re-init
    healthy = np.asarray(res.fitness) >= cfg.tracker.fitness_reinit_threshold
    assert not np.any(np.asarray(res2.reinitialized)[healthy])
    # the state keeps one layout from step to step (jit compiles once per
    # input sharding): object-axis fields sharded, the rest replicated
    obj_sh = jax.sharding.NamedSharding(sweep.mesh,
                                        jax.sharding.PartitionSpec("obj"))
    for name in ("poses", "fitness", "initialized", "coverage",
                 "prev_poses", "vel_ok", "pose_tracked"):
        a = getattr(st2, name)
        assert a.sharding.is_equivalent_to(obj_sh, a.ndim), name
    assert st2.key.sharding.is_fully_replicated
    assert st2.frame_idx.sharding.is_fully_replicated
    # checkpoint round-trip
    sweep.save_state(st2, "/tmp/sweep_state.npz")
    st3 = sweep.load_state("/tmp/sweep_state.npz")
    assert np.allclose(np.asarray(st3.poses), np.asarray(st2.poses))


def test_sweep_rejects_mismatched_objects(tiny):
    cfg, obj, hand, frame = tiny
    other = ObjectModel(meshio.make_test_object("box"), model_points=128,
                        render_points=512)
    with pytest.raises(ValueError, match="share"):
        LibrarySweep([obj, other], hand, cfg)


def test_sharded_outputs_bitwise_replicated(tiny):
    """The whole sharded frame step — polish, finisher, hypothesis
    extraction — must be bitwise-replicated across shards (out_specs
    declares P() with check_vma=False, so divergence would be silent).
    ADVICE r2 suspected the score-only finisher diverges (shard-unique
    perturbation keys); it does not: swarm_best all_gathers the
    per-shard champions every finisher iteration, so every shard sees
    the same argmax. This test pins that invariant."""
    import functools
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    cfg, obj, hand, frame = tiny
    mesh8 = make_mesh(8, "p")
    est = Estimator(obj, hand, cfg, mesh=mesh8, axis_name="p")
    dyn, static = est.frame_args(
        jnp.asarray(frame.depth), jnp.asarray(frame.pose_gt),
        jnp.asarray(frame.hand_base), jnp.asarray(frame.hand_q),
        key=jax.random.key(3), mode="track",
    )
    fn = functools.partial(
        est._frame_step,
        n_particles=static["n_particles"] // mesh8.size,
        pso_iters=static["pso_iters"],
        resample_after=static["resample_after"],
        prescreen=static["prescreen"],
    )

    def probe(*args):
        out = fn(*args)
        return (jax.lax.all_gather(out.pose, "p"),
                jax.lax.all_gather(out.fitness, "p"),
                jax.lax.all_gather(out.hyp_poses, "p"))

    sm = shard_map(probe, mesh=mesh8, in_specs=(P(),) * 10, out_specs=P(),
                   check_vma=False)
    poses, fits, hyps = jax.jit(sm)(*dyn)
    assert float(jnp.abs(poses - poses[0]).max()) == 0.0
    assert float(jnp.abs(fits - fits[0]).max()) == 0.0
    assert float(jnp.abs(hyps - hyps[0]).max()) == 0.0


def test_multi_hypothesis_count_validated(tiny):
    """Too many hypothesis priors for the per-shard swarm must raise a
    clear error at the API boundary, not an opaque trace-time repeat
    failure (ADVICE r2)."""
    cfg, obj, hand, frame = tiny
    est = Estimator(obj, hand, cfg, mesh=make_mesh(8, "p"))
    prev = jnp.tile(jnp.asarray(frame.pose_gt)[None], (4, 1, 1))
    # 16 particles / 8 shards = 2 per shard < 2 * 4 hypotheses
    with pytest.raises(ValueError, match="hypothesis priors"):
        est.estimate(
            jnp.asarray(frame.depth), prev,
            jnp.asarray(frame.hand_base), jnp.asarray(frame.hand_q),
        )


def test_graft_entry_single_chip():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out.pose)
    assert out.pose.shape == (4, 4)
    assert np.isfinite(float(out.fitness))


def test_graft_dryrun_multichip():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_library_sweep_2d_mesh(tiny):
    """Composed DP: 4 objects x 2-way particle sharding on a 4x2 mesh."""
    import numpy as np2
    from jax.sharding import Mesh

    cfg, obj, hand, frame = tiny
    objs = [
        ObjectModel(meshio.make_test_object("box"), model_points=256,
                    render_points=512, seed=i)
        for i in range(4)
    ]
    mesh2d = Mesh(np2.asarray(jax.devices()).reshape(4, 2), ("obj", "p"))
    sweep = LibrarySweep(objs, hand, cfg, mesh=mesh2d, axis_name="obj",
                         particle_axis="p")
    st = sweep.init_state()
    depths = jnp.tile(jnp.asarray(frame.depth)[None], (4, 1, 1))
    hbs = jnp.tile(jnp.asarray(frame.hand_base)[None], (4, 1, 1))
    hqs = jnp.tile(jnp.asarray(frame.hand_q)[None], (4, 1))
    st, res = sweep.step(st, depths, hbs, hqs)
    assert res.poses.shape == (4, 4, 4)
    assert bool(jnp.all(jnp.isfinite(res.fitness)))
    # second (track-mode) step refines the global init of frame 0
    st, res = sweep.step(st, depths, hbs, hqs)
    adds = [
        float(se3.add_s_error(res.poses[i], jnp.asarray(frame.pose_gt),
                              objs[i].model_pts))
        for i in range(4)
    ]
    assert max(adds) < 0.03, adds


def test_sweep_init_matches_single_object_init(tiny):
    """The sweep's init program must BE the single-object init program
    (VERDICT r3 item 1): same statics (reinit particles/iters, delayed
    resample, prescreen, init-only scoring -> reinit ICP cadence) and
    same traced args. With matched keys the O=1 sweep init is bitwise
    the Estimator mode='init' result."""
    cfg, obj, hand, frame = tiny
    sweep = LibrarySweep([obj], hand, cfg)
    est = Estimator(obj, hand, cfg)
    depth = jnp.asarray(frame.depth)
    hb = jnp.asarray(frame.hand_base)
    hq = jnp.asarray(frame.hand_q)
    key = jax.random.key(5)
    dyn, static = est.frame_args(depth, jnp.eye(4), hb, hq, key=key,
                                 mode="init")
    out_single = est._step_jit(*dyn, **static)
    out_sweep = sweep._run(
        key[None], depth[None], jnp.eye(4)[None], hb[None], hq[None], "init"
    )
    assert float(jnp.abs(out_sweep.pose[0] - out_single.pose).max()) == 0.0
    assert float(out_sweep.fitness[0]) == float(out_single.fitness)
    assert float(out_sweep.coverage[0]) == float(out_single.coverage)


def test_sweep_mixed_reinit_and_coverage_watchdog(tiny):
    """Mixed frames merge per object (track program for healthy objects,
    init program for collapsed ones), and the coverage watchdog fires on
    a drifted-but-confident state (high fitness, collapsed coverage —
    the documented 71 mm mode, score.py header) within ONE frame."""
    cfg, obj, hand, frame = tiny
    objs = [
        ObjectModel(meshio.make_test_object("box"), model_points=256,
                    render_points=512, seed=i)
        for i in range(2)
    ]
    sweep = LibrarySweep(objs, hand, cfg)
    depths = jnp.tile(jnp.asarray(frame.depth)[None], (2, 1, 1))
    hbs = jnp.tile(jnp.asarray(frame.hand_base)[None], (2, 1, 1))
    hqs = jnp.tile(jnp.asarray(frame.hand_q)[None], (2, 1))
    st, res = sweep.step(sweep.init_state(), depths, hbs, hqs)
    assert bool(jnp.all(res.reinitialized))
    # fitness collapse on object 1 only
    st1 = st._replace(fitness=st.fitness.at[1].set(0.0))
    st2, res2 = sweep.step(st1, depths, hbs, hqs)
    assert list(np.asarray(res2.reinitialized)) == [False, True]
    # coverage collapse at HIGH fitness on object 0 only
    st3 = st2._replace(
        fitness=jnp.full_like(st2.fitness, 1.0),
        coverage=st2.coverage.at[0].set(0.001),
    )
    _, res3 = sweep.step(st3, depths, hbs, hqs)
    assert list(np.asarray(res3.reinitialized)) == [True, False]


def test_sweep_multi_hypothesis(tiny):
    """Sweep-mode competing-basin tracking (VERDICT r3 item 7): H=2
    hypothesis slots per object persist across frames, slot 0 is the
    committed pose, empty slots carry fitness -inf."""
    import dataclasses
    cfg, obj, hand, frame = tiny
    cfg2 = dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, n_hypotheses=2)
    )
    objs = [
        ObjectModel(meshio.make_test_object("box"), model_points=256,
                    render_points=512, seed=i)
        for i in range(2)
    ]
    sweep = LibrarySweep(objs, hand, cfg2)
    depths = jnp.tile(jnp.asarray(frame.depth)[None], (2, 1, 1))
    hbs = jnp.tile(jnp.asarray(frame.hand_base)[None], (2, 1, 1))
    hqs = jnp.tile(jnp.asarray(frame.hand_q)[None], (2, 1))
    st, res = sweep.step(sweep.init_state(), depths, hbs, hqs)
    st, res = sweep.step(st, depths, hbs, hqs)
    assert res.hyp_poses.shape == (2, 2, 4, 4)
    assert res.hyp_fitness.shape == (2, 2)
    # slot 0 is the committed best pose
    assert float(jnp.abs(res.hyp_poses[:, 0] - res.poses).max()) == 0.0
    for i in range(2):
        err = float(se3.add_s_error(res.poses[i], jnp.asarray(frame.pose_gt),
                                    objs[i].model_pts))
        assert err < 0.03


def test_sweep_motion_prior(tiny):
    """Constant-velocity prior in sweep mode: the 2-prior stack tracks a
    moving sequence; velocity only engages after two TRACKED frames."""
    import dataclasses
    cfg, obj, hand, frame = tiny
    cfg2 = dataclasses.replace(
        cfg, tracker=dataclasses.replace(cfg.tracker, motion_prior=0.8)
    )
    sweep = LibrarySweep([obj], hand, cfg2)
    depths = jnp.asarray(frame.depth)[None]
    hbs = jnp.asarray(frame.hand_base)[None]
    hqs = jnp.asarray(frame.hand_q)[None]
    st = sweep.init_state()
    st, _ = sweep.step(st, depths, hbs, hqs)        # init frame
    assert not bool(st.vel_ok[0])
    st, _ = sweep.step(st, depths, hbs, hqs)        # first tracked frame
    assert not bool(st.vel_ok[0])                   # base was an init pose
    st, res = sweep.step(st, depths, hbs, hqs)      # velocity engages
    assert bool(st.vel_ok[0])
    err = float(se3.add_s_error(res.poses[0], jnp.asarray(frame.pose_gt),
                                obj.model_pts))
    assert err < 0.03


def test_sweep_shared_scene_object0_bitwise(tiny):
    """shared_scene=True (model-library mode: ONE frame, O candidate
    models) computes _scene_prep once and broadcasts it. Object 0's key
    derivation matches the per-scene path exactly, so its init result is
    bitwise identical to the per-scene sweep fed O copies of the frame;
    the step() API then runs with unbatched inputs and the watchdog
    merges mixed frames as in the per-scene mode."""
    cfg, obj, hand, frame = tiny
    objs = [
        ObjectModel(meshio.make_test_object(s), model_points=256,
                    render_points=512, seed=i)
        for i, s in enumerate(["box", "cylinder"])
    ]
    per = LibrarySweep(objs, hand, cfg)
    sh = LibrarySweep(objs, hand, cfg, shared_scene=True)
    depth = jnp.asarray(frame.depth)
    hb = jnp.asarray(frame.hand_base)
    hq = jnp.asarray(frame.hand_q)
    keys = jax.random.split(jax.random.key(5), 2)
    prev = jnp.tile(jnp.eye(4)[None], (2, 1, 1))
    out_per = per._run(
        keys, jnp.tile(depth[None], (2, 1, 1)), prev,
        jnp.tile(hb[None], (2, 1, 1)), jnp.tile(hq[None], (2, 1)), "init",
    )
    out_sh = sh._run(keys, depth, prev, hb, hq, "init")
    assert float(jnp.abs(out_sh.pose[0] - out_per.pose[0]).max()) == 0.0
    assert float(out_sh.fitness[0]) == float(out_per.fitness[0])
    # full public step() with unbatched inputs
    st, res = sh.step(sh.init_state(), depth, hb, hq)
    assert res.poses.shape == (2, 4, 4)
    assert bool(jnp.all(res.reinitialized))
    # mixed frame: fitness collapse on object 1 only
    st1 = st._replace(fitness=st.fitness.at[1].set(0.0))
    _, res2 = sh.step(st1, depth, hb, hq)
    assert list(np.asarray(res2.reinitialized)) == [False, True]


def test_sweep_shared_scene_sharded(tiny):
    """Shared-scene library over the 8-device mesh: replicated frame,
    object-sharded search. The candidates matching the observed object
    (box) must land on it; a wrong-shape candidate cannot out-fit the
    true model's pose quality."""
    cfg, obj, hand, frame = tiny
    shapes = ["box", "cylinder", "sphere", "ellipsoid"] * 2
    objs = [
        ObjectModel(meshio.make_test_object(s), model_points=256,
                    render_points=512, seed=i)
        for i, s in enumerate(shapes)
    ]
    sweep = LibrarySweep(objs, hand, cfg, mesh=make_mesh(8, "obj"),
                         axis_name="obj", shared_scene=True)
    depth = jnp.asarray(frame.depth)
    hb = jnp.asarray(frame.hand_base)
    hq = jnp.asarray(frame.hand_q)
    st, res = sweep.step(sweep.init_state(), depth, hb, hq)
    st, res = sweep.step(st, depth, hb, hq)
    assert res.poses.shape == (8, 4, 4)
    assert bool(jnp.all(jnp.isfinite(res.fitness)))
    for i in (0, 4):  # the true-shape candidates
        err = float(se3.add_s_error(res.poses[i], jnp.asarray(frame.pose_gt),
                                    objs[i].model_pts))
        assert err < 0.03, f"box candidate {i}: {err*1000:.1f}mm"


def test_shared_scene_validation(tiny):
    cfg, obj, hand, frame = tiny
    import numpy as np2
    from jax.sharding import Mesh

    mesh2d = Mesh(np2.asarray(jax.devices()).reshape(4, 2), ("obj", "p"))
    objs = [ObjectModel(meshio.make_test_object("box"), model_points=256,
                        render_points=512, seed=i) for i in range(4)]
    with pytest.raises(ValueError, match="shared_scene"):
        LibrarySweep(objs, hand, cfg, mesh=mesh2d, axis_name="obj",
                     particle_axis="p", shared_scene=True)
    sh = LibrarySweep([obj], hand, cfg, shared_scene=True)
    with pytest.raises(ValueError, match="ONE frame"):
        sh.step(sh.init_state(), jnp.zeros((1, 48, 64)))
    per = LibrarySweep([obj], hand, cfg)
    with pytest.raises(ValueError, match="per-scene"):
        per.step(per.init_state(), jnp.zeros((48, 64)))


def test_library_sweep_2d_validation(tiny):
    cfg, obj, hand, frame = tiny
    import numpy as np2
    from jax.sharding import Mesh

    mesh2d = Mesh(np2.asarray(jax.devices()).reshape(4, 2), ("obj", "p"))
    objs = [ObjectModel(meshio.make_test_object("box"), model_points=256,
                        render_points=512, seed=i) for i in range(3)]
    with pytest.raises(ValueError, match="divisible"):
        LibrarySweep(objs, hand, cfg, mesh=mesh2d, axis_name="obj",
                     particle_axis="p")
