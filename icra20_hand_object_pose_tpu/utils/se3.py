"""SE(3) / SO(3) math core.

Rebuild of the reference's Eigen-based pose utilities
(reference: src/Utils.* — quaternion/rotation conversions, pose
composition, random pose perturbation sampling; see SURVEY.md §3
"SE(3) utilities"). Everything here is pure jnp, shape-polymorphic
over leading batch axes, and differentiable, so it can live inside
jit/vmap/scan without host round-trips.

Conventions:
  - Rotations: 3x3 matrices (row-major, act on column vectors x' = R @ x).
  - Quaternions: wxyz order, unit norm, w >= 0 canonicalization optional.
  - Poses: 4x4 homogeneous matrices as the canonical on-device form;
    compact (quat[4], t[3]) 7-vectors for swarm state.
  - Twists: 6-vectors [omega(3), v(3)] — rotation first, translation second.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-9

# DEFAULT-precision f32 matmuls may run in TF32 on the GPU; pose math is
# tiny but correctness-critical, so every contraction here pins full f32.
_PREC = jax.lax.Precision.HIGHEST


def _mm(a, b):
    return jnp.matmul(a, b, precision=_PREC)


# ---------------------------------------------------------------------------
# Quaternions (wxyz)
# ---------------------------------------------------------------------------

def quat_normalize(q: jax.Array) -> jax.Array:
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), _EPS)


def quat_multiply(a: jax.Array, b: jax.Array) -> jax.Array:
    """Hamilton product a*b, both wxyz."""
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conjugate(q: jax.Array) -> jax.Array:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_to_matrix(q: jax.Array) -> jax.Array:
    """Unit quaternion (wxyz) -> 3x3 rotation matrix."""
    q = quat_normalize(q)
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(R: jax.Array) -> jax.Array:
    """3x3 rotation matrix -> unit quaternion (wxyz).

    Branch-free (jnp.where) Shepperd-style extraction so it is safe under
    jit/vmap for any input rotation, including trace <= 0 cases.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    # Four candidate extractions, each numerically good in its own regime.
    tw = 1.0 + m00 + m11 + m22  # 4w^2
    tx = 1.0 + m00 - m11 - m22  # 4x^2
    ty = 1.0 - m00 + m11 - m22  # 4y^2
    tz = 1.0 - m00 - m11 + m22  # 4z^2

    def safe_sqrt(v):
        return jnp.sqrt(jnp.maximum(v, _EPS))

    qw = jnp.stack([tw, m21 - m12, m02 - m20, m10 - m01], -1) / (2.0 * safe_sqrt(tw))[..., None]
    qx = jnp.stack([m21 - m12, tx, m01 + m10, m02 + m20], -1) / (2.0 * safe_sqrt(tx))[..., None]
    qy = jnp.stack([m02 - m20, m01 + m10, ty, m12 + m21], -1) / (2.0 * safe_sqrt(ty))[..., None]
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, tz], -1) / (2.0 * safe_sqrt(tz))[..., None]

    # Pick the branch with the largest pivot.
    t = jnp.stack([tw, tx, ty, tz], -1)
    idx = jnp.argmax(t, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], -2)  # [..., 4cand, 4comp]
    q = jnp.take_along_axis(cands, idx[..., None, None].astype(jnp.int32), axis=-2)[..., 0, :]
    # Canonicalize sign (w >= 0) and normalize.
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SO(3) exp / log
# ---------------------------------------------------------------------------

def hat(w: jax.Array) -> jax.Array:
    """Vector [..,3] -> skew-symmetric matrix [..,3,3]."""
    wx, wy, wz = jnp.moveaxis(w, -1, 0)
    z = jnp.zeros_like(wx)
    m = jnp.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], axis=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_exp(w: jax.Array) -> jax.Array:
    """Rotation vector [..,3] -> rotation matrix [..,3,3] (Rodrigues).

    Taylor-guarded near theta = 0 so gradients are finite.
    """
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    small = theta2 < 1e-8
    # sin(t)/t and (1-cos(t))/t^2 with series fallbacks
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, _EPS))
    W = hat(w)
    I = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), W.shape)
    return I + a[..., None, None] * W + b[..., None, None] * _mm(W, W)


def so3_log(R: jax.Array) -> jax.Array:
    """Rotation matrix [..,3,3] -> rotation vector [..,3].

    Uses the quaternion route, which is stable for angles near 0 and pi.
    """
    q = matrix_to_quat(R)
    w, v = q[..., 0], q[..., 1:]
    nv = jnp.linalg.norm(v, axis=-1)
    # angle = 2*atan2(|v|, w); axis = v/|v|
    angle = 2.0 * jnp.arctan2(nv, w)
    scale = jnp.where(nv < 1e-7, 2.0 / jnp.maximum(w, _EPS), angle / jnp.maximum(nv, _EPS))
    return v * scale[..., None]


# ---------------------------------------------------------------------------
# SE(3): 4x4 matrices
# ---------------------------------------------------------------------------

def make_pose(R: jax.Array, t: jax.Array) -> jax.Array:
    """(R [..,3,3], t [..,3]) -> 4x4 pose."""
    batch = jnp.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = jnp.broadcast_to(R, batch + (3, 3))
    t = jnp.broadcast_to(t, batch + (3,))
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def identity_pose(dtype=jnp.float32) -> jax.Array:
    return jnp.eye(4, dtype=dtype)


def rotation(T: jax.Array) -> jax.Array:
    return T[..., :3, :3]


def translation(T: jax.Array) -> jax.Array:
    return T[..., :3, 3]


def compose(A: jax.Array, B: jax.Array) -> jax.Array:
    return _mm(A, B)


def inverse(T: jax.Array) -> jax.Array:
    R = rotation(T)
    t = translation(T)
    Rt = jnp.swapaxes(R, -1, -2)
    return make_pose(Rt, -jnp.einsum("...ij,...j->...i", Rt, t, precision=_PREC))


def _rotate_fma(R: jax.Array, pts: jax.Array) -> jax.Array:
    """[...,3,3] x [...,N,3] as 9 broadcast FMAs.

    An einsum with Precision.HIGHEST over a K=3 contraction becomes a
    batched matmul of depth 3; the unrolled form is exact f32 and fuses
    into its consumers.
    """
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    Rb = R[..., None, :, :]  # broadcast over the point axis
    return jnp.stack(
        [
            Rb[..., 0, 0] * x + Rb[..., 0, 1] * y + Rb[..., 0, 2] * z,
            Rb[..., 1, 0] * x + Rb[..., 1, 1] * y + Rb[..., 1, 2] * z,
            Rb[..., 2, 0] * x + Rb[..., 2, 1] * y + Rb[..., 2, 2] * z,
        ],
        axis=-1,
    )


def transform_points(T: jax.Array, pts: jax.Array) -> jax.Array:
    """Apply pose(s) [..,4,4] to points [..,N,3]."""
    R = rotation(T)
    t = translation(T)
    return _rotate_fma(R, pts) + t[..., None, :]


def rotate_vectors(T: jax.Array, vecs: jax.Array) -> jax.Array:
    return _rotate_fma(rotation(T), vecs)


def se3_exp(xi: jax.Array) -> jax.Array:
    """Twist [..,6] = [omega, v] -> 4x4 pose (full exponential map with V)."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    small = theta2 < 1e-8
    R = so3_exp(w)
    W = hat(w)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / jnp.maximum(theta2, _EPS))
    c = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / jnp.maximum(theta2 * theta, _EPS),
    )
    I = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), W.shape)
    V = I + b[..., None, None] * W + c[..., None, None] * _mm(W, W)
    t = jnp.einsum("...ij,...j->...i", V, v, precision=_PREC)
    return make_pose(R, t)


def se3_log(T: jax.Array) -> jax.Array:
    """4x4 pose -> twist [..,6] = [omega, v]."""
    w = so3_log(rotation(T))
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    small = theta2 < 1e-8
    W = hat(w)
    # V^{-1} = I - W/2 + (1/theta^2)(1 - theta*sin/(2(1-cos))) W^2
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - theta * jnp.sin(theta) / jnp.maximum(2.0 * (1.0 - jnp.cos(theta)), _EPS))
        / jnp.maximum(theta2, _EPS),
    )
    I = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), W.shape)
    Vinv = I - 0.5 * W + cot_term[..., None, None] * _mm(W, W)
    v = jnp.einsum("...ij,...j->...i", Vinv, translation(T), precision=_PREC)
    return jnp.concatenate([w, v], axis=-1)


def apply_twist(xi: jax.Array, T: jax.Array) -> jax.Array:
    """Left-multiply update: exp(xi) @ T. The ICP/PSO update convention."""
    return _mm(se3_exp(xi), T)


def apply_twist_about(xi: jax.Array, T: jax.Array, anchor: jax.Array) -> jax.Array:
    """Anchor-conjugated update: Trans(a) exp(xi) Trans(-a) @ T.

    The rotation part of xi acts about `anchor` [..,3] instead of the
    camera origin — essential conditioning for objects ~0.5m from the
    camera, where an origin-anchored rotation is mostly a translation.
    """
    E = se3_exp(xi)
    Rw, vw = rotation(E), translation(E)
    R = _mm(Rw, rotation(T))
    t = (
        jnp.einsum("...ij,...j->...i", Rw, translation(T) - anchor, precision=_PREC)
        + anchor
        + vw
    )
    return make_pose(R, t)


# ---------------------------------------------------------------------------
# Compact pose7 = (quat wxyz, t) state for swarms
# ---------------------------------------------------------------------------

def pose_to_pose7(T: jax.Array) -> jax.Array:
    return jnp.concatenate([matrix_to_quat(rotation(T)), translation(T)], axis=-1)


def pose7_to_pose(p: jax.Array) -> jax.Array:
    return make_pose(quat_to_matrix(p[..., :4]), p[..., 4:])


# ---------------------------------------------------------------------------
# Random sampling
# ---------------------------------------------------------------------------

def random_quat(key: jax.Array, shape=()) -> jax.Array:
    """Uniform random unit quaternions (Shoemake)."""
    u = jax.random.uniform(key, shape + (3,))
    u1, u2, u3 = u[..., 0], u[..., 1], u[..., 2]
    a, b = jnp.sqrt(1.0 - u1), jnp.sqrt(u1)
    tau = 2.0 * jnp.pi
    return jnp.stack(
        [
            b * jnp.cos(tau * u3),
            a * jnp.sin(tau * u2),
            a * jnp.cos(tau * u2),
            b * jnp.sin(tau * u3),
        ],
        axis=-1,
    )


def random_rotation(key: jax.Array, shape=()) -> jax.Array:
    return quat_to_matrix(random_quat(key, shape))


def super_fibonacci_rotations(n: int, key: jax.Array | None = None) -> jax.Array:
    """n near-optimally-spread SO(3) rotations (super-Fibonacci spirals,
    Alexa CVPR'22) — low-discrepancy coverage for global-init orientation
    seeding. iid random rotations leave ~40-degree holes at n=128; the
    spiral's worst gap is far smaller at the same n, which decides
    whether the true basin is visited at all (measured r2: a 128-sample
    random init repeatedly locked a pseudo-symmetric wrong basin that a
    covered init escapes). With `key`, the whole grid is offset by one
    random rotation so repeated re-inits don't alias."""
    i = jnp.arange(n, dtype=jnp.float32) + 0.5
    phi = jnp.sqrt(2.0)
    psi = 1.533751168755204288118041  # the "super-golden" constant
    s = i / n
    r = jnp.sqrt(s)
    R = jnp.sqrt(1.0 - s)
    alpha = 2.0 * jnp.pi * i / phi
    beta = 2.0 * jnp.pi * i / psi
    q = jnp.stack(
        [r * jnp.sin(alpha), r * jnp.cos(alpha),
         R * jnp.sin(beta), R * jnp.cos(beta)], axis=-1,
    )
    rot = quat_to_matrix(q)
    if key is not None:
        rot = _mm(random_rotation(key)[None], rot)
    return rot


def perturb_pose(
    key: jax.Array,
    T: jax.Array,
    rot_sigma: jax.Array | float,
    trans_sigma: jax.Array | float,
    shape=(),
) -> jax.Array:
    """Sample poses around T: Gaussian twists anchored at the object.

    The rotation noise acts about T's own translation (the object
    position), so rot_sigma perturbs attitude without flinging the
    object sideways by lever-arm  — the behavior the reference's
    per-particle SE(3) perturbation sampling has, since it perturbs
    object-frame poses (SURVEY.md §3 "PSO / particle optimizer").
    rot_sigma in radians, trans_sigma in meters.
    """
    kw, kv = jax.random.split(key)
    w = jax.random.normal(kw, shape + (3,)) * rot_sigma
    v = jax.random.normal(kv, shape + (3,)) * trans_sigma
    xi = jnp.concatenate([w, v], axis=-1)
    Tb = jnp.broadcast_to(T, shape + (4, 4))
    return apply_twist_about(xi, Tb, translation(Tb))


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

def rotation_angle_deg(Ra: jax.Array, Rb: jax.Array) -> jax.Array:
    """Geodesic angle between rotations, degrees."""
    cos = (jnp.einsum("...ij,...ij->...", Ra, Rb, precision=_PREC) - 1.0) / 2.0
    return jnp.degrees(jnp.arccos(jnp.clip(cos, -1.0, 1.0)))


def add_s_error(T_est: jax.Array, T_gt: jax.Array, model_pts: jax.Array) -> jax.Array:
    """ADD-S (symmetric average distance) between two poses of a model cloud.

    For each ground-truth-posed model point, distance to the closest
    estimated-posed model point, averaged. The standard 6-DoF pose metric
    the reference evaluates with (SURVEY.md §5).
    model_pts: [N,3]; poses broadcastable [..,4,4]. Returns [..].
    """
    pe = transform_points(T_est, model_pts)   # [..,N,3]
    pg = transform_points(T_gt, model_pts)    # [..,N,3]
    d2 = jnp.sum((pg[..., :, None, :] - pe[..., None, :, :]) ** 2, axis=-1)
    return jnp.mean(jnp.sqrt(jnp.min(d2, axis=-1)), axis=-1)


def add_error(T_est: jax.Array, T_gt: jax.Array, model_pts: jax.Array) -> jax.Array:
    """ADD (average distance, matched points)."""
    pe = transform_points(T_est, model_pts)
    pg = transform_points(T_gt, model_pts)
    return jnp.mean(jnp.linalg.norm(pe - pg, axis=-1), axis=-1)
