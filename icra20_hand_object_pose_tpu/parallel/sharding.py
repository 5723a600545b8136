"""Device-mesh utilities and the multi-object library sweep.

Scaling layer (SURVEY.md §3 parallelism table; BASELINE config 5). The
reference is single-process C++ with no distribution; the two
data-parallel axes this rebuild shards over several devices are:

  - the PARTICLE axis of one tracked object's swarm (Estimator(mesh=...)
    -> shard_map over "p"; per-iteration global-best agreement is a tiny
    all_gather — ops/pso.py `swarm_best`), and
  - the OBJECT axis of a model-library sweep: every object of the
    dataset tracked concurrently, one vmapped frame program partitioned
    over the mesh with NO cross-object communication (pure DP).

Both run on a virtual CPU mesh for testing
(XLA_FLAGS=--xla_force_host_platform_device_count=N, SURVEY.md §5.5).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.estimator import Estimator, FrameResult, _ckpt_path
from ..models.hand import HandModel
from ..models.object_model import ObjectModel
from ..utils import se3
from ..utils.config import EstimatorConfig


def make_mesh(n_devices: int | None = None, axis_name: str = "p") -> Mesh:
    """1-D mesh over the first n_devices (default: all)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


class SweepState(NamedTuple):
    """Per-object tracker state, batched: the whole library's resumable
    state is one small pytree (SURVEY.md §6 checkpoint/resume)."""
    poses: jax.Array        # [O,4,4]
    fitness: jax.Array      # [O]
    initialized: jax.Array  # [O] bool
    key: jax.Array
    frame_idx: jax.Array    # int32
    coverage: jax.Array | None = None     # [O] watchdog second signal
    hyp_poses: jax.Array | None = None    # [O,H,4,4] competing basins (H>1)
    hyp_fitness: jax.Array | None = None  # [O,H]
    prev_poses: jax.Array | None = None   # [O,4,4] pose one frame earlier
    vel_ok: jax.Array | None = None       # [O] bool: prev_poses usable for
                                          # the constant-velocity prior
                                          # (both endpoints TRACKED frames
                                          # — mirrors Tracker.pose_tracked)
    pose_tracked: jax.Array | None = None  # [O] bool: `poses` from a
                                           # tracked (not init) frame


class SweepResult(NamedTuple):
    poses: jax.Array        # [O,4,4]
    fitness: jax.Array      # [O]
    coverage: jax.Array     # [O]
    reinitialized: jax.Array  # [O] bool — which objects re-registered
    hyp_poses: jax.Array | None = None    # [O,H,4,4] when n_hypotheses > 1
    hyp_fitness: jax.Array | None = None  # [O,H]


class LibrarySweep:
    """Track O objects concurrently, object axis sharded over a mesh.

    Unlike the reference (one PoseEstimator process per object, run
    sequentially), the whole library is ONE jit: model tensors are
    stacked [O,...], the frame program is vmapped over the object axis,
    and jit in/out shardings place each object's tracker on its mesh
    shard.

    Re-initialization runs the SAME global-registration program as the
    single-object path (Estimator.frame_args mode='init'): the
    4096-orientation prescreen, delayed elite resample, init-only
    neutral-coverage scoring, reinit particle count and the heavier
    reinit ICP cadence are statics of a SECOND compiled sweep variant.
    Each frame the host reads the per-object watchdog (fitness +
    coverage, exactly Tracker.step's predicate) and dispatches the track
    program, the init program, or — on mixed frames — both, merging
    per-object by the need-init mask. Mixed frames pay one extra sweep
    call; re-init is a rare event and the init program stays fully
    object-sharded over the mesh (unlike a per-object host loop would).
    """

    def __init__(
        self,
        objects: Sequence[ObjectModel],
        hand: HandModel | None,
        cfg: EstimatorConfig = EstimatorConfig(),
        mesh: Mesh | None = None,
        axis_name: str = "obj",
        particle_axis: str | None = None,
        shared_scene: bool = False,
    ):
        """With a 2-D mesh and `particle_axis` set (e.g.
        Mesh(devices.reshape(4, 2), ("obj", "p")), particle_axis="p"), the
        sweep composes BOTH data-parallel axes: each object's swarm is
        additionally sharded over the particle axis, with the per-
        iteration global-best agreement as an all_gather over "p" within
        each object's device column — objects over one mesh dimension,
        particles over the other.

        `shared_scene=True` is the model-LIBRARY mode (the reference's
        primary multi-model use: ONE observed frame, O candidate models —
        which object is in the hand, and where?): step() then takes an
        unbatched depth [H,W] / hand_base [4,4] / hand_q [J], the
        object-independent frame work (hand masks, fused preprocessing,
        hand removal — Estimator._scene_prep) runs ONCE and is broadcast
        into the vmapped per-object search instead of being replicated
        O times. Object 0's result is bitwise identical to the per-scene
        path fed O copies of the frame (same key-split order); the others
        differ only in which scene subsample they see."""
        if not objects:
            raise ValueError("need at least one object")
        if shared_scene and particle_axis is not None:
            raise ValueError(
                "shared_scene composes with the 1-D object mesh only; "
                "drop particle_axis or use the per-scene mode"
            )
        shapes = {
            (o.model_pts.shape, o.render_pts.shape) for o in objects
        }
        if len(shapes) != 1:
            raise ValueError(
                "objects must share model/render point counts; build them "
                "with the same ObjectModel(model_points=, render_points=)"
            )
        self.objects = list(objects)
        self.n_objects = len(objects)
        self.cfg = cfg
        self.mesh = mesh
        self.axis_name = axis_name
        self.particle_axis = particle_axis
        self.shared_scene = shared_scene
        n_p = 1
        if particle_axis is not None:
            if mesh is None or particle_axis not in mesh.axis_names:
                raise ValueError(
                    f"particle_axis {particle_axis!r} needs a mesh with that "
                    f"axis (got {mesh.axis_names if mesh else None})"
                )
            if self.n_objects % mesh.shape[axis_name]:
                raise ValueError(
                    f"{self.n_objects} objects not divisible by mesh axis "
                    f"{axis_name}={mesh.shape[axis_name]}"
                )
            n_p = mesh.shape[particle_axis]
        H = cfg.tracker.n_hypotheses
        if H > 1:
            for name, count in (("pso.particles", cfg.pso.particles),
                                ("tracker.reinit_particles",
                                 cfg.tracker.reinit_particles)):
                if count // n_p < 2 * H:
                    raise ValueError(
                        f"{H} hypotheses need at least {2 * H} particles per "
                        f"shard; {name}={count}"
                        + (f" over {n_p} particle shards" if n_p > 1 else "")
                    )
        # one estimator provides the traced frame program; its per-object
        # tensors are passed explicitly (vmapped axis 0)
        self._est = Estimator(objects[0], hand, cfg)
        if particle_axis is not None:
            # make _frame_step emit the cross-shard global-best all_gather
            # over the particle axis (it runs inside our shard_map below)
            self._est.mesh = mesh
            self._est.axis_name = particle_axis
        self._model_pts = jnp.stack([o.model_pts for o in objects])
        self._model_normals = jnp.stack([o.model_normals for o in objects])
        self._render_pts = jnp.stack([o.render_pts for o in objects])
        self._render_normals = jnp.stack([o.render_normals for o in objects])
        self._render_w = jnp.stack([o.render_w for o in objects])
        # per-object symmetry groups, identity-padded to the library's max
        # group size (identity rows are harmless duplicates in the
        # branch-snap argmin — ops/pso.snap_to_branch)
        s_max = max(o.symmetries.shape[0] for o in objects)
        self._symmetries = jnp.stack([
            jnp.concatenate([
                o.symmetries,
                jnp.tile(jnp.eye(4, dtype=jnp.float32)[None],
                         (s_max - o.symmetries.shape[0], 1, 1)),
            ]) if o.symmetries.shape[0] < s_max else o.symmetries
            for o in objects
        ])
        self._diameters = np.asarray([o.diameter for o in objects], np.float32)

        obj_sharding = (
            NamedSharding(mesh, P(axis_name)) if mesh is not None else None
        )
        kwargs = {}
        if obj_sharding is not None:
            # shared-scene mode: the frame inputs (depth, hand) are
            # unbatched and REPLICATED over the mesh; prep runs once per
            # device on its replica, the search partitions over objects.
            rep = NamedSharding(mesh, P())
            kwargs = dict(
                in_shardings=(
                    obj_sharding,  # keys
                    rep if shared_scene else obj_sharding,  # depth(s)
                    obj_sharding,  # prev poses
                    rep if shared_scene else obj_sharding,  # hand base(s)
                    rep if shared_scene else obj_sharding,  # hand q(s)
                    (obj_sharding,) * 6,  # object tensors
                    obj_sharding,  # rot_sigma [O]
                    obj_sharding,  # trans_sigma [O]
                    obj_sharding,  # uniform_rot [O]
                    obj_sharding,  # roi_radius [O]
                ),
                out_shardings=FrameResult(
                    pose=obj_sharding, fitness=obj_sharding,
                    coverage=obj_sharding, fitness_trace=obj_sharding,
                    n_scene=obj_sharding,
                    hyp_poses=obj_sharding, hyp_fitness=obj_sharding,
                    # auto-armed base correction: per-object in sweep mode
                    # (carried only by the single-object Tracker; sweeps
                    # re-register per trial, so SweepState does not
                    # accumulate it)
                    hand_delta=obj_sharding,
                ),
            )
        statics = (10, 11, 12, 13, 14)
        if particle_axis is not None:
            # 2-D path: one shard_map over (obj, particle) — object args
            # sharded over `axis_name`, replicated over `particle_axis`;
            # inside, each shard runs its slice of objects (vmap) with a
            # per-shard slice of each swarm (_frame_step's axis_name RNG
            # fold + all_gather global best over the particle axis).
            from jax import shard_map

            def sweep2d(
                keys, depths, prev_poses, hand_bases, hand_qs, obj_tensors,
                rot_sigma, trans_sigma, uniform_rot, roi_radius,
                n_particles: int, pso_iters: int,
                resample_after: int, prescreen: int, init_scoring: bool,
            ):
                if n_particles % n_p:
                    raise ValueError(
                        f"particles={n_particles} not divisible by mesh "
                        f"axis {particle_axis}={n_p}"
                    )

                def local(*args10):
                    fn = partial(
                        self._est._frame_step,
                        n_particles=n_particles // n_p,
                        pso_iters=pso_iters,
                        resample_after=resample_after,
                        prescreen=prescreen,
                        init_scoring=init_scoring,
                    )
                    return jax.vmap(fn)(*args10)

                sm = shard_map(
                    local, mesh=mesh,
                    in_specs=(P(axis_name),) * 10,
                    out_specs=P(axis_name), check_vma=False,
                )
                return sm(
                    keys, depths, prev_poses, hand_bases, hand_qs,
                    obj_tensors, rot_sigma, trans_sigma, uniform_rot,
                    roi_radius,
                )

            self._sweep_jit = jax.jit(sweep2d, static_argnums=statics)
        else:
            # pjit with in_shardings forbids kwargs: statics go positional
            self._sweep_jit = jax.jit(
                self._sweep_step_shared if shared_scene else self._sweep_step,
                static_argnums=statics, **kwargs,
            )
        # step()'s glue (RNG splits, prior construction, merge + state
        # update) is jitted: run eagerly it was ~20 small device dispatches
        # per frame. Jitted glue + ONE packed watchdog fetch leaves 4
        # dispatches + 1 tiny fetch.
        prep_kwargs = {}
        if obj_sharding is not None:
            # _prep's outputs feed _sweep_jit, whose in_shardings demand
            # the object axis; emit them already placed (key replicated).
            prep_kwargs = dict(out_shardings=(
                None, obj_sharding, obj_sharding,  # key, keys_track/init
                obj_sharding, obj_sharding,        # prev_t, prev_i
                obj_sharding,                      # need_init
            ))
        self._prep_jit = jax.jit(self._prep, **prep_kwargs)
        self._finish_jit = jax.jit(self._finish, static_argnums=(0,))
        # host-side speculation hint (see step): True when the previous
        # frame left at least one object tracked, i.e. the track program
        # will (almost surely) be needed this frame too
        self._spec_track = False

    def _sweep_step(
        self, keys, depths, prev_poses, hand_bases, hand_qs, obj_tensors,
        rot_sigma, trans_sigma, uniform_rot, roi_radius,
        n_particles: int, pso_iters: int,
        resample_after: int, prescreen: int, init_scoring: bool,
    ) -> FrameResult:
        fn = partial(
            self._est._frame_step, n_particles=n_particles,
            pso_iters=pso_iters, resample_after=resample_after,
            prescreen=prescreen, init_scoring=init_scoring,
        )
        return jax.vmap(fn)(
            keys, depths, prev_poses, hand_bases, hand_qs, obj_tensors,
            rot_sigma, trans_sigma, uniform_rot, roi_radius,
        )

    def _sweep_step_shared(
        self, keys, depth, prev_poses, hand_base, hand_q, obj_tensors,
        rot_sigma, trans_sigma, uniform_rot, roi_radius,
        n_particles: int, pso_iters: int,
        resample_after: int, prescreen: int, init_scoring: bool,
    ) -> FrameResult:
        """Shared-scene sweep program: ONE _scene_prep over the single
        observed frame, then the per-object search vmapped over the
        (mesh-sharded) object axis with the prep broadcast. Key-split
        order matches _frame_step exactly, so object 0 reproduces the
        per-scene path bitwise (pinned in tests/test_sharding.py)."""
        sub = jax.vmap(partial(jax.random.split, num=4))(keys)  # [O,4]
        prep = self._est._scene_prep(
            sub[0, 0], sub[0, 1], depth, hand_base, hand_q, init_scoring
        )
        fn = partial(
            self._est._search, n_particles=n_particles,
            pso_iters=pso_iters, resample_after=resample_after,
            prescreen=prescreen, init_scoring=init_scoring,
        )
        return jax.vmap(fn, in_axes=(0, 0, None, 0, 0, 0, 0, 0, 0))(
            sub[:, 2], sub[:, 3], prep, prev_poses, obj_tensors,
            rot_sigma, trans_sigma, uniform_rot, roi_radius,
        )

    # -- public API ----------------------------------------------------------

    def init_state(self, seed: int = 0) -> SweepState:
        O = self.n_objects
        H = self.cfg.tracker.n_hypotheses
        return SweepState(
            poses=jnp.tile(jnp.eye(4)[None], (O, 1, 1)),
            fitness=jnp.zeros((O,)),
            initialized=jnp.zeros((O,), bool),
            key=jax.random.key(seed),
            frame_idx=jnp.asarray(0, jnp.int32),
            coverage=jnp.ones((O,)),
            hyp_poses=(jnp.tile(jnp.eye(4)[None, None], (O, H, 1, 1))
                       if H > 1 else None),
            hyp_fitness=(jnp.full((O, H), -jnp.inf) if H > 1 else None),
            prev_poses=jnp.tile(jnp.eye(4)[None], (O, 1, 1)),
            vel_ok=jnp.zeros((O,), bool),
            pose_tracked=jnp.zeros((O,), bool),
        )

    def _run(self, keys, depths, prev, hand_bases, hand_qs, mode: str):
        """One compiled sweep call with the SAME static/traced arguments
        the single-object Estimator.frame_args builds for `mode`."""
        cfg = self.cfg
        tr = cfg.tracker
        O = self.n_objects
        obj_tensors = (
            self._model_pts, self._model_normals,
            self._render_pts, self._render_normals, self._render_w,
            self._symmetries,
        )
        f32 = lambda v: jnp.full((O,), v, jnp.float32)
        if mode == "track":
            roi_track = np.maximum(
                1.5 * self._diameters, 3.0 * cfg.pso.trans_sigma
            ).astype(np.float32)
            return self._sweep_jit(
                keys, depths, prev, hand_bases, hand_qs, obj_tensors,
                f32(cfg.pso.rot_sigma), f32(cfg.pso.trans_sigma),
                jnp.zeros((O,), bool), jnp.asarray(roi_track),
                cfg.pso.particles, cfg.pso.iters, 0, 0, False,
            )
        # mode == "init": mirror Estimator.frame_args(mode="init") exactly —
        # reinit sigmas, uniform orientations, no ROI crop, reinit particle
        # count, doubled iterations, delayed resample, orientation
        # prescreen, init-only scoring (which also swaps in the heavier
        # reinit_icp_* cadence inside _frame_step).
        pso_iters = max(cfg.pso.iters, 2 * cfg.pso.iters)
        return self._sweep_jit(
            keys, depths, prev, hand_bases, hand_qs, obj_tensors,
            f32(tr.reinit_rot_sigma), f32(tr.reinit_trans_sigma),
            jnp.ones((O,), bool), f32(np.inf),
            tr.reinit_particles, pso_iters, pso_iters // 2,
            tr.reinit_prescreen, True,
        )

    def _prep(self, state: SweepState):
        """Jitted per-frame glue, part 1 (see __init__): RNG splits, the
        watchdog predicate, and BOTH modes' prior stacks in one device
        program. The watchdog predicate is the SAME as Tracker.step's
        (fitness collapse OR coverage collapse), evaluated on device and
        returned as one [O] bool for a single tiny host fetch."""
        cfg = self.cfg
        tr = cfg.tracker
        O = self.n_objects
        H = tr.n_hypotheses
        key, k_t, k_i = jax.random.split(state.key, 3)
        keys_track = jax.random.split(k_t, O)
        keys_init = jax.random.split(k_i, O)
        need_init = (~state.initialized) | (
            state.fitness < tr.fitness_reinit_threshold
        )
        if tr.coverage_reinit_threshold > 0.0 and state.coverage is not None:
            need_init |= state.initialized & (
                state.coverage < tr.coverage_reinit_threshold
            )
        # tracked-mode prior: competing-basin hypotheses (H>1) or the
        # constant-velocity 2-prior stack (H==1, motion_prior>0) —
        # the batched mirror of Tracker.step's prior construction.
        alpha = tr.motion_prior
        if H > 1 and state.hyp_poses is not None:
            prev_t = jnp.where(
                jnp.isfinite(state.hyp_fitness)[..., None, None],
                state.hyp_poses, state.poses[:, None],
            )
        elif H == 1 and alpha > 0.0:
            pp = (state.prev_poses if state.prev_poses is not None
                  else state.poses)
            delta = se3.compose(state.poses, se3.inverse(pp))
            if alpha != 1.0:
                delta = se3.se3_exp(alpha * se3.se3_log(delta))
            vel_ok = (state.vel_ok if state.vel_ok is not None
                      else jnp.zeros((O,), bool))
            delta = jnp.where(
                vel_ok[:, None, None], delta, jnp.eye(4, dtype=delta.dtype)
            )
            predicted = se3.compose(delta, state.poses)
            prev_t = jnp.stack([predicted, state.poses], axis=1)  # [O,2,4,4]
        else:
            prev_t = (state.poses if H == 1
                      else jnp.tile(state.poses[:, None], (1, H, 1, 1)))
        prev_i = (state.poses if H == 1
                  else jnp.tile(state.poses[:, None], (1, H, 1, 1)))
        return key, keys_track, keys_init, prev_t, prev_i, need_init

    def _finish(self, mode: str, state: SweepState, key, need_init,
                out_t: FrameResult | None, out_i: FrameResult | None):
        """Jitted per-frame glue, part 2 (see __init__): merge track/init
        results by the watchdog mask and build the next SweepState.
        `mode` is static — 'track' / 'init' / 'both' name step()'s three
        dispatch patterns (each a distinct trace anyway, since the unused
        FrameResult is None)."""
        O = self.n_objects
        H = self.cfg.tracker.n_hypotheses
        m = need_init
        if mode == "init":
            pose, fitness, coverage = out_i.pose, out_i.fitness, out_i.coverage
            hyp_p, hyp_f = out_i.hyp_poses, out_i.hyp_fitness
        elif mode == "track":
            pose, fitness, coverage = out_t.pose, out_t.fitness, out_t.coverage
            hyp_p, hyp_f = out_t.hyp_poses, out_t.hyp_fitness
        else:
            sel = lambda a, b: jnp.where(
                m.reshape((O,) + (1,) * (a.ndim - 1)), a, b
            )
            pose = sel(out_i.pose, out_t.pose)
            fitness = sel(out_i.fitness, out_t.fitness)
            coverage = sel(out_i.coverage, out_t.coverage)
            if H > 1:
                hyp_p = sel(out_i.hyp_poses, out_t.hyp_poses)
                hyp_f = sel(out_i.hyp_fitness, out_t.hyp_fitness)
            else:  # shapes can differ (motion-prior 2-stack); unused anyway
                hyp_p, hyp_f = out_t.hyp_poses, out_t.hyp_fitness

        tracked = ~m
        new_state = SweepState(
            poses=pose,
            fitness=fitness,
            initialized=jnp.ones((O,), bool),
            key=key,
            frame_idx=state.frame_idx + 1,
            coverage=coverage,
            hyp_poses=hyp_p if H > 1 else None,
            hyp_fitness=hyp_f if H > 1 else None,
            # constant-velocity bookkeeping (mirrors Tracker): the delta's
            # base must itself be a TRACKED pose — an init pose's residual
            # folded into the "velocity" extrapolates the error
            prev_poses=state.poses,
            vel_ok=tracked & (state.pose_tracked
                              if state.pose_tracked is not None
                              else jnp.zeros((O,), bool)),
            pose_tracked=tracked,
        )
        return new_state, SweepResult(
            poses=pose, fitness=fitness, coverage=coverage,
            reinitialized=m,
            hyp_poses=hyp_p if H > 1 else None,
            hyp_fitness=hyp_f if H > 1 else None,
        )

    def step(
        self,
        state: SweepState,
        depths: jax.Array,      # [O,H,W] meters; shared_scene: [H,W]
        hand_bases: jax.Array | None = None,  # [O,4,4]; shared: [4,4]
        hand_qs: jax.Array | None = None,     # [O,J]; shared: [J]
    ) -> tuple[SweepState, SweepResult]:
        """One frame for every object in the library."""
        O = self.n_objects
        J = self._est.hand.n_joints if self._est.hand is not None else 1
        if self.shared_scene:
            if depths.ndim != 2:
                raise ValueError(
                    f"shared_scene takes ONE frame [H,W], got {depths.shape}"
                )
            if hand_bases is None:
                hand_bases = jnp.eye(4)
            if hand_qs is None:
                hand_qs = jnp.zeros((J,))
        else:
            if depths.ndim != 3 or depths.shape[0] != O:
                raise ValueError(
                    f"per-scene sweep takes [O,H,W] depths (O={O}), got "
                    f"{depths.shape}; use shared_scene=True for one frame"
                )
            if hand_bases is None:
                hand_bases = jnp.tile(jnp.eye(4)[None], (O, 1, 1))
            if hand_qs is None:
                hand_qs = jnp.zeros((O, J))
        state = self._place(state)
        key, keys_track, keys_init, prev_t, prev_i, need_init = (
            self._prep_jit(state)
        )
        # Speculative dispatch (mirrors Tracker.step): when the previous
        # frame left any object tracked, the track program is needed this
        # frame too unless EVERY object's watchdog fired at once — so it
        # is dispatched before the watchdog mask is read and the fetch's
        # round-trip hides under device compute.
        out_t = None
        if self._spec_track:
            out_t = self._run(
                keys_track, depths, prev_t, hand_bases, hand_qs, "track"
            )
        # the ONE host fetch per frame: the [O] watchdog mask. The two
        # modes are different compiled programs (static swarm shapes), so
        # the dispatch below cannot be a device-side cond.
        ni = np.asarray(need_init)
        any_init = bool(ni.any())
        all_init = bool(ni.all())
        self._spec_track = not all_init
        if all_init:
            out_t = None  # discard a mispredicted speculative run
        elif out_t is None:
            out_t = self._run(
                keys_track, depths, prev_t, hand_bases, hand_qs, "track"
            )
        out_i = None if not any_init else self._run(
            keys_init, depths, prev_i, hand_bases, hand_qs, "init"
        )
        mode = ("both" if (out_t is not None and out_i is not None)
                else "track" if out_t is not None else "init")
        new_state, result = self._finish_jit(
            mode, state, key, need_init, out_t, out_i)
        return self._place(new_state), result

    def _place(self, state: SweepState) -> SweepState:
        """Pin every state field to one layout: object-axis fields sharded
        over the mesh, the rest replicated. jit compiles once per input
        sharding, so a state whose layout drifted from step to step (as
        the glue programs' outputs did) recompiled the glue and the sweep
        program on later steps."""
        if self.mesh is None:
            return state
        obj = NamedSharding(self.mesh, P(self.axis_name))
        rep = NamedSharding(self.mesh, P())
        return jax.tree_util.tree_map(
            lambda a: jax.device_put(
                a, obj if a.ndim and a.shape[0] == self.n_objects else rep),
            state)

    # -- checkpoint / resume -------------------------------------------------

    def save_state(self, state: SweepState, path: str) -> None:
        extra = {}
        for name in ("coverage", "hyp_poses", "hyp_fitness", "prev_poses",
                     "vel_ok", "pose_tracked"):
            v = getattr(state, name)
            if v is not None:
                extra[name] = np.asarray(v)
        np.savez(
            _ckpt_path(path),
            poses=np.asarray(state.poses),
            fitness=np.asarray(state.fitness),
            initialized=np.asarray(state.initialized),
            key=np.asarray(jax.random.key_data(state.key)),
            frame_idx=np.asarray(state.frame_idx),
            **extra,
        )

    def load_state(self, path: str) -> SweepState:
        z = np.load(_ckpt_path(path))
        opt = lambda n: jnp.asarray(z[n]) if n in z else None
        return SweepState(
            poses=jnp.asarray(z["poses"]),
            fitness=jnp.asarray(z["fitness"]),
            initialized=jnp.asarray(z["initialized"]),
            key=jax.random.wrap_key_data(jnp.asarray(z["key"])),
            frame_idx=jnp.asarray(z["frame_idx"]),
            coverage=opt("coverage"),
            hyp_poses=opt("hyp_poses"),
            hyp_fitness=opt("hyp_fitness"),
            prev_poses=opt("prev_poses"),
            vel_ok=opt("vel_ok"),
            pose_tracked=opt("pose_tracked"),
        )
