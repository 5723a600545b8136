"""Adaptive-hand kinematic model, segmentation, and occlusion masks.

Rebuild of the reference's Hand/HandT42 classes (SURVEY.md §3
"Hand kinematic model" / "Hand segmentation": load finger meshes +
kinematic tree, forward kinematics under actuation uncertainty, classify
scene points as hand vs object, render hand for occlusion masking).

Redesign for XLA:
  - the kinematic tree is STATIC structure (a python loop over ~5 links
    at trace time); only joint angles are traced tensors;
  - actuation uncertainty (underactuated gripper, no joint encoders) is
    a vmapped batch of K sampled finger configurations — the reference
    samples hand configurations serially when building occlusion masks;
  - segmentation is one fused distance + min pass scene x hand-cloud, over
    the K config axis — no KD-tree;
  - the occlusion mask is a point-splat hand depth buffer shared with
    the object renderer (ops/render.py).

The built-in T42 geometry is procedural (capsule phalanges + box palm),
standing in for the Yale OpenHand T42 mesh assets of the released
dataset; `HandModel` accepts arbitrary link meshes (e.g. loaded .obj)
with the same kinematic description.
"""
from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import knn, render
from ..utils import meshio, se3


def _rot_about(axis: np.ndarray) -> np.ndarray:
    axis = np.asarray(axis, np.float32)
    n = np.linalg.norm(axis)
    return axis / n if n > 0 else axis


@dataclass
class HandLink:
    """One rigid link of the hand.

    origin: static [4,4] transform parent-frame -> joint frame.
    axis: revolute axis in joint frame ([0,0,0] = fixed link).
    joint: index into the actuated-angle vector q (-1 = fixed).
    coupling/rest: link angle = coupling * q[joint] + rest — models the
    underactuated distal joints of adaptive hands (distal flexion is a
    mechanical function of the single finger tendon).
    """
    name: str
    mesh: meshio.Mesh
    parent: int
    origin: np.ndarray
    axis: np.ndarray
    joint: int = -1
    coupling: float = 1.0
    rest: float = 0.0


class HandModel:
    """Device-ready hand: FK + point clouds + segmentation + occlusion."""

    def __init__(self, links: list[HandLink], n_joints: int, points_per_link: int = 256):
        self.links = links
        self.n_joints = n_joints
        self.points_per_link = points_per_link
        pts, nrms = [], []
        for li, link in enumerate(links):
            p, n = link.mesh.sample_surface(points_per_link, seed=1000 + li)
            pts.append(p)
            nrms.append(n)
        self._link_pts = jnp.asarray(np.stack(pts))          # [L,Pl,3]
        self._link_normals = jnp.asarray(np.stack(nrms))     # [L,Pl,3]
        self._origins = jnp.asarray(np.stack([l.origin for l in links]))  # [L,4,4]
        self._axes = [jnp.asarray(_rot_about(l.axis)) for l in links]

    @property
    def num_links(self) -> int:
        return len(self.links)

    @property
    def num_points(self) -> int:
        return self.num_links * self.points_per_link

    # -- forward kinematics -------------------------------------------------

    def fk(self, q: jax.Array) -> jax.Array:
        """Joint angles q [J] -> link transforms [L,4,4] in hand-base frame.

        Static python loop over the link tree; fully traceable/vmappable.
        """
        Ts = []
        for li, link in enumerate(self.links):
            parent_T = jnp.eye(4) if link.parent < 0 else Ts[link.parent]
            local = self._origins[li]
            if link.joint >= 0:
                ang = link.coupling * q[link.joint] + link.rest
                R = se3.so3_exp(self._axes[li] * ang)
                local = se3.compose(local, se3.make_pose(R, jnp.zeros(3)))
            Ts.append(se3.compose(parent_T, local))
        return jnp.stack(Ts)

    def cloud(self, base_pose: jax.Array, q: jax.Array) -> jax.Array:
        """Hand surface points in camera frame: [L*Pl, 3]."""
        Ts = se3.compose(base_pose[None], self.fk(q))          # [L,4,4]
        pts = se3.transform_points(Ts, self._link_pts)          # [L,Pl,3]
        return pts.reshape(-1, 3)

    def sampled_clouds(
        self, key: jax.Array, base_pose: jax.Array, q_nominal: jax.Array,
        sigma: float, n_samples: int,
    ) -> jax.Array:
        """K sampled finger configs (actuation uncertainty) -> [K, L*Pl, 3].

        First sample is always the nominal configuration.
        """
        noise = jax.random.normal(key, (n_samples, self.n_joints)) * sigma
        noise = noise.at[0].set(0.0)
        qs = jnp.clip(q_nominal[None] + noise, 0.0, jnp.pi)
        return jax.vmap(lambda q: self.cloud(base_pose, q))(qs)

    # -- hand-mount calibration refinement ------------------------------------

    def refine_base(
        self,
        key: jax.Array,
        depth: jax.Array,        # [H,W] observed depth, meters
        valid: jax.Array,        # [H,W] bool
        base0: jax.Array,        # [4,4] reported hand base (camera frame)
        q: jax.Array,            # [J] nominal joint angles
        *,
        fx: float, fy: float, cx: float, cy: float,
        height: int, width: int,
        iters: int = 3,
        candidates: int = 16,
        rot_sigma: float = 0.06,
        trans_sigma: float = 0.012,
        q_sigma: float = 0.12,
        anneal: float = 0.5,
        tau: float = 0.008,
        radius: int = 3,
    ) -> jax.Array:
        """Annealed render-space search correcting the hand BASE pose.

        The reported hand base carries hand-mount CALIBRATION error
        (systematic mm/deg offset between the robot's kinematic chain and
        the camera frame; a 3-degree extrinsic error at 0.5 m displaces
        the hand ~25 mm), which the K-sampled finger configs cannot
        absorb: they perturb joint angles only, so every sampled mask
        inherits the same base offset. Wrong masks then misclassify
        pixels both ways — object evidence near the hand is dropped, true
        hand pixels leak into the object cloud — and under grasp
        occlusion a flipped pose can out-score truth on the corrupted
        evidence (measured r4: the realistic-regime init failures and the
        persistent-flip tracking mode).

        The hand is VISIBLE in the depth image, so its base is
        observable. Attraction-based fitting (projective point-to-plane
        GN on the hand cloud) was tried first and DIVERGES here: with the
        object millimeters from the fingers, nearest-surface residuals
        cannot tell hand pixels from object pixels, and the fit walks
        onto the object (measured: 3 deg initial error grew to 68 deg in
        8 iterations while "inliers" increased). The occlusion-aware
        render-space agreement score (config_agreement: continuous depth
        match + in-front contradiction + ghost penalties) does make that
        distinction, so the correction is found the same way the swarm
        finds object poses — score-space search: `candidates` sampled
        base perturbations per round (twists about the hand centroid,
        sigma annealed each round), incumbent always in slot 0 so the
        score can never regress below the reported base.

        Each candidate also carries its OWN sampled joint config
        (q_sigma): with the base alone searched at a wrong nominal q, the
        winning base compensates the finger error (measured: a ~6 mm
        base-cloud offset OUT-SCORES truth at q 0.15 rad off), whereas
        joint sampling puts a (true-base, true-q) combination in the
        candidate set. Only the base is returned — downstream q handling
        stays with the sampled-config selection.

        Measured (box grasp, VGA->160p grid, q 0.15 rad off, 6 calib
        draws at 3 deg/5 mm extrinsic error = 3-29 mm hand displacement):
        hand-cloud error 9-18 mm -> 4-7 mm. The ~5 mm floor is the
        radius-3 splat footprint on the min-pooled grid; an
        exactly-calibrated base drifts to ~5 mm for the same reason —
        both inside the segmentation/occlusion mask tolerance
        (HandConfig.segment_dist = 8 mm), which is why this stays off by
        default in calibrated setups.
        """
        best_b, best_q = base0, q
        sr, st, sq = rot_sigma, trans_sigma, q_sigma
        for k in jax.random.split(key, iters):
            kb, kq = jax.random.split(k)
            cands = jnp.concatenate([
                best_b[None],
                se3.perturb_pose(kb, best_b, sr, st, shape=(candidates - 1,)),
            ])
            qn = jax.random.normal(kq, (candidates, self.n_joints)) * sq
            qn = qn.at[0].set(0.0)
            cq = jnp.clip(best_q[None] + qn, 0.0, jnp.pi)
            clouds = jax.vmap(self.cloud)(cands, cq)
            agree = self.config_agreement(
                clouds, depth, valid,
                fx=fx, fy=fy, cx=cx, cy=cy, height=height, width=width,
                tau=tau, radius=radius,
            )
            i = jnp.argmax(agree)
            best_b, best_q = cands[i], cq[i]
            sr, st, sq = sr * anneal, st * anneal, sq * anneal
        return best_b

    # -- observation-driven configuration weighting ---------------------------

    @staticmethod
    def config_agreement(
        clouds: jax.Array,        # [K,Nh,3] sampled configs, camera frame
        depth: jax.Array,         # [H,W] observed depth (meters)
        valid: jax.Array,         # [H,W] bool
        *,
        fx: float, fy: float, cx: float, cy: float,
        height: int, width: int,
        tau: float = 0.008,
        radius: int = 3,
    ) -> jax.Array:
        """[K] observed-depth agreement score per sampled finger config.

        The hand is underactuated — no reliable encoders (SURVEY.md §1) —
        so the nominal q may be wrong. Each sampled config is scored in
        RENDER space: the config's cloud is splat to a depth image and
        compared pixelwise to the observed depth. Per rendered pixel:
        a continuous match kernel (1 - |r - d|/tau) supports the config,
        rendering IN FRONT of a measured surface (r < d - tau)
        contradicts it (the camera would have seen that finger there),
        rendering over a NO-RETURN pixel is a milder ghost penalty;
        pixels behind the observed surface are neutral (plausibly
        occluded). Normalized by the config's rendered-pixel count.

        Render space rather than point space because both sides must
        carry the SAME surface representation: scoring raw surface
        points against a splat/sensor depth inherits the splat's min-z
        closer-bias, which a slightly-displaced wrong config can
        accidentally compensate (measured: +0.3 rad-wrong configs
        out-scored truth point-wise at 160x120). `radius` must be large
        enough that the sparse link clouds splat to contiguous
        footprints; 3 is robust for the 128-256 points-per-link range.
        """
        obs = jnp.where(valid, depth, jnp.inf)

        def splat(pts):
            return render.splat_depth(
                pts, jnp.ones(pts.shape[0], pts.dtype),
                fx=fx, fy=fy, cx=cx, cy=cy,
                height=height, width=width, radius=radius,
            )

        rend = jax.vmap(splat)(clouds)                # [K,H,W], +inf empty
        r_valid = jnp.isfinite(rend)
        both = r_valid & jnp.isfinite(obs)[None]
        dt = clouds.dtype
        # mask operands BEFORE subtracting: inf - inf on a non-`both`
        # pixel would make a (masked, but jax_debug_nans-tripping) NaN
        diff = jnp.where(
            both,
            jnp.where(r_valid, rend, 0.0) - jnp.where(
                jnp.isfinite(obs), obs, 0.0)[None],
            jnp.inf,
        )
        support = jnp.clip(1.0 - jnp.abs(diff) / tau, 0.0, 1.0)
        front = (both & (diff < -tau)).astype(dt)
        ghost = (r_valid & ~jnp.isfinite(obs)[None]).astype(dt)
        n = jnp.maximum(jnp.sum(r_valid.astype(dt), (1, 2)), 1.0)
        return (
            jnp.sum(support, (1, 2))
            - jnp.sum(front, (1, 2))
            - 0.5 * jnp.sum(ghost, (1, 2))
        ) / n

    # -- segmentation -------------------------------------------------------

    def segment_mask(
        self, scene_pts: jax.Array, hand_clouds: jax.Array, segment_dist: float
    ) -> jax.Array:
        """True where a scene point belongs to the hand.

        scene_pts [Ns,3]; hand_clouds [K,Nh,3] (sampled configs). A point
        is hand if its distance to ANY sampled hand cloud is below
        segment_dist — conservative removal, mirroring the reference's
        distance-to-hand-mesh test (SURVEY.md §3 "Hand segmentation").
        One fused distance + min pass over all K configs.
        """
        flat = hand_clouds.reshape(-1, 3)
        d2 = knn.pairwise_sqdist(scene_pts, flat)
        return jnp.min(d2, axis=-1) < segment_dist * segment_dist

    # -- occlusion ----------------------------------------------------------

    def depth(
        self, base_pose: jax.Array, q: jax.Array, *,
        fx: float, fy: float, cx: float, cy: float, height: int, width: int,
        radius: int = 1,
    ) -> jax.Array:
        """Hand depth buffer [H,W] (+inf empty) for finger-occlusion masks."""
        pts = self.cloud(base_pose, q)
        w = jnp.ones(pts.shape[0])
        return render.splat_depth(
            pts, w, fx=fx, fy=fy, cx=cx, cy=cy, height=height, width=width,
            radius=radius,
        )

    def depth_union(
        self, base_pose: jax.Array, qs_clouds: jax.Array, *,
        fx: float, fy: float, cx: float, cy: float, height: int, width: int,
        radius: int = 1,
    ) -> jax.Array:
        """Conservative occluder depth: min-z over K sampled configs.

        qs_clouds [K,Nh,3] from sampled_clouds (already camera frame).
        """
        pts = qs_clouds.reshape(-1, 3)
        w = jnp.ones(pts.shape[0])
        return render.splat_depth(
            pts, w, fx=fx, fy=fy, cx=cx, cy=cy, height=height, width=width,
            radius=radius,
        )

    def merged_mesh(self, q: np.ndarray) -> meshio.Mesh:
        """Host-side posed hand mesh (for synthetic dataset rendering)."""
        Ts = np.asarray(self.fk(jnp.asarray(q, jnp.float32)))
        out: meshio.Mesh | None = None
        for li, link in enumerate(self.links):
            m = link.mesh.transformed(Ts[li])
            out = m if out is None else out.merged(m)
        assert out is not None
        return out


# ---------------------------------------------------------------------------
# File-driven hand description (real mesh assets plug in with no code change)
# ---------------------------------------------------------------------------

def _rpy_matrix(rpy) -> np.ndarray:
    r, p, y = [float(v) for v in rpy]
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], np.float32)
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]], np.float32)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]], np.float32)
    return Rz @ Ry @ Rx


def _spec_mesh(entry: dict, base_dir: str) -> meshio.Mesh:
    if "mesh" in entry:
        import os

        path = entry["mesh"]
        if not os.path.isabs(path):
            path = os.path.join(base_dir, path)
        return meshio.load_mesh(path)
    prim = dict(entry["primitive"])
    kind = prim.pop("kind")
    makers = {
        "box": meshio.make_box,
        "capsule": meshio.make_capsule,
        "cylinder": meshio.make_cylinder,
        "sphere": meshio.make_icosphere,
    }
    if kind not in makers:
        raise ValueError(f"unknown primitive kind {kind!r}")
    return makers[kind](**prim)


def load_hand_spec(path: str) -> HandModel:
    """Build a HandModel from a YAML hand description.

    The reference ships its T42 / Model O as mesh assets + kinematic
    parameters (SURVEY.md §3 "Hand kinematic model"); this loader is the
    drop-in point for those real assets — each link takes either a mesh
    file (relative paths resolve against the spec's directory) or a
    procedural primitive, plus the same kinematic fields as HandLink:

        n_joints: 2
        points_per_link: 256        # optional
        links:
          - name: palm
            parent: -1              # index or parent link NAME
            origin: {xyz: [0,0,0], rpy: [0,0,0]}   # or a 4x4 row-major list
            primitive: {kind: box, extents: [0.075, 0.028, 0.04]}
          - name: fA_prox
            parent: palm
            origin: {xyz: [0.034, 0.0, 0.018]}
            axis: [0, 1, 0]
            joint: 0
            coupling: -1.0
            rest: 0.0
            mesh: meshes/proximal.obj
    """
    import os

    import yaml

    with open(path) as f:
        spec = yaml.safe_load(f)
    base_dir = os.path.dirname(os.path.abspath(path))
    names: dict[str, int] = {}
    links: list[HandLink] = []
    for entry in spec["links"]:
        parent = entry.get("parent", -1)
        if isinstance(parent, str):
            if parent not in names:
                raise ValueError(
                    f"link {entry['name']!r}: unknown parent {parent!r} "
                    "(parents must be declared first)"
                )
            parent = names[parent]
        origin = entry.get("origin", {})
        if isinstance(origin, list):
            T = np.asarray(origin, np.float32).reshape(4, 4)
        else:
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = _rpy_matrix(origin.get("rpy", (0.0, 0.0, 0.0)))
            T[:3, 3] = np.asarray(origin.get("xyz", (0.0, 0.0, 0.0)), np.float32)
        joint = int(entry.get("joint", -1))
        if joint >= spec["n_joints"]:
            raise ValueError(
                f"link {entry['name']!r}: joint {joint} out of range "
                f"(n_joints={spec['n_joints']})"
            )
        names[entry["name"]] = len(links)
        links.append(HandLink(
            name=entry["name"],
            mesh=_spec_mesh(entry, base_dir),
            parent=parent,
            origin=T,
            axis=np.asarray(entry.get("axis", (0.0, 0.0, 0.0)), np.float32),
            joint=joint,
            coupling=float(entry.get("coupling", 1.0)),
            rest=float(entry.get("rest", 0.0)),
        ))
    return HandModel(
        links, n_joints=int(spec["n_joints"]),
        points_per_link=int(spec.get("points_per_link", 256)),
    )


# ---------------------------------------------------------------------------
# Procedural Yale OpenHand T42-class gripper
# ---------------------------------------------------------------------------

def make_t42_hand(points_per_link: int = 256) -> HandModel:
    """Two-finger underactuated gripper approximating the OpenHand T42.

    Hand-base frame: palm center at origin, fingers extend along +z,
    finger separation along x, joint axes along y. One actuated tendon
    angle per finger (J=2); distal joints couple at 0.7x with a rest
    curl, as in adaptive underactuated designs.
    """
    palm = meshio.make_box((0.075, 0.028, 0.04), center=(0.0, 0.0, 0.0))
    prox = meshio.make_capsule(radius=0.010, length=0.050)
    dist = meshio.make_capsule(radius=0.008, length=0.040)

    def T(t, R=np.eye(3)):
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = R
        M[:3, 3] = t
        return M

    links = [
        HandLink("palm", palm, parent=-1, origin=T([0, 0, 0]), axis=np.zeros(3)),
        # finger A (+x side) curls toward -x (axis +y)
        HandLink("fA_prox", prox, parent=0, origin=T([+0.034, 0.0, 0.018]),
                 axis=np.array([0, 1, 0]), joint=0, coupling=-1.0),
        HandLink("fA_dist", dist, parent=1, origin=T([0.0, 0.0, 0.050]),
                 axis=np.array([0, 1, 0]), joint=0, coupling=-0.7, rest=-0.15),
        # finger B (-x side) curls toward +x (axis -y equivalent: +y, positive angle)
        HandLink("fB_prox", prox, parent=0, origin=T([-0.034, 0.0, 0.018]),
                 axis=np.array([0, 1, 0]), joint=1, coupling=+1.0),
        HandLink("fB_dist", dist, parent=3, origin=T([0.0, 0.0, 0.050]),
                 axis=np.array([0, 1, 0]), joint=1, coupling=+0.7, rest=0.15),
    ]
    return HandModel(links, n_joints=2, points_per_link=points_per_link)


def make_model_o_hand(points_per_link: int = 256) -> HandModel:
    """Three-finger underactuated gripper approximating the OpenHand
    Model O (the reference dataset's second hand besides the T42:
    SURVEY.md §1 "Yale OpenHand-class ... Model T42 / Model O").

    Hand-base frame matches make_t42_hand: palm at origin, fingers along
    +z. Two opposing fingers on the +x side, one thumb on the -x side;
    J=3 actuated tendons (one per finger) with coupled distal joints.
    """
    palm = meshio.make_cylinder(radius=0.045, height=0.035, segments=24)
    prox = meshio.make_capsule(radius=0.010, length=0.055)
    dist = meshio.make_capsule(radius=0.008, length=0.042)

    def T(t, R=np.eye(3)):
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = R
        M[:3, 3] = t
        return M

    def rot_z(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    links = [
        HandLink("palm", palm, parent=-1, origin=T([0, 0, 0]),
                 axis=np.zeros(3)),
    ]
    # fingers at +x +/- 25mm y (curl toward -x), thumb at -x (curl +x)
    specs = [
        ("f1", [+0.034, +0.025, 0.016], np.array([0, 1, 0]), -1.0),
        ("f2", [+0.034, -0.025, 0.016], np.array([0, 1, 0]), -1.0),
        ("thumb", [-0.034, 0.0, 0.016], np.array([0, 1, 0]), +1.0),
    ]
    for j, (name, base, axis, sgn) in enumerate(specs):
        pidx = len(links)
        links.append(HandLink(
            f"{name}_prox", prox, parent=0, origin=T(base),
            axis=axis, joint=j, coupling=sgn,
        ))
        links.append(HandLink(
            f"{name}_dist", dist, parent=pidx, origin=T([0.0, 0.0, 0.055]),
            axis=axis, joint=j, coupling=sgn * 0.7, rest=sgn * 0.15,
        ))
    return HandModel(links, n_joints=3, points_per_link=points_per_link)
