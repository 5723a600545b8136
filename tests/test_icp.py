"""ICP tests: NumPy oracle for the GN step, synthetic-frame convergence,
batch consistency (SURVEY.md §5.1-5.3; BASELINE.json configs 1-2)."""
import jax
import jax.numpy as jnp
import numpy as np
from scipy.spatial import cKDTree

from icra20_hand_object_pose_tpu.ops import icp, knn
from icra20_hand_object_pose_tpu.utils import meshio, se3


def test_knn_matches_kdtree():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(500, 3)).astype(np.float32)
    r = rng.normal(size=(300, 3)).astype(np.float32)
    idx, d2 = knn.nn(jnp.asarray(q), jnp.asarray(r))
    tree = cKDTree(r)
    d_ref, idx_ref = tree.query(q)
    np.testing.assert_array_equal(np.asarray(idx), idx_ref)
    np.testing.assert_allclose(np.sqrt(np.asarray(d2)), d_ref, atol=1e-5)


def test_gn_step_vs_lstsq_oracle():
    """One GN step == weighted least squares on the linearized residual."""
    rng = np.random.default_rng(1)
    n = 200
    p = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    nrm = rng.normal(size=(n, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    s = p + rng.normal(size=(n, 3)).astype(np.float32) * 0.01
    w = (rng.random(n) > 0.3).astype(np.float32)

    xi, rmse = icp.solve_gn_step(
        jnp.asarray(s), jnp.asarray(p), jnp.asarray(nrm), jnp.asarray(w), damping=0.0
    )
    # numpy oracle
    r = np.sum(nrm * (s - p), axis=-1)
    J = np.concatenate([np.cross(p, nrm), nrm], axis=-1)
    sw = np.sqrt(w)
    xi_ref, *_ = np.linalg.lstsq(J * sw[:, None], r * sw, rcond=None)
    np.testing.assert_allclose(np.asarray(xi), xi_ref, atol=1e-4)
    rmse_ref = np.sqrt(np.sum(w * r * r) / w.sum())
    np.testing.assert_allclose(float(rmse), rmse_ref, atol=1e-6)


def test_gn_step_zero_inliers_freezes():
    z = jnp.zeros((50, 3))
    xi, _ = icp.solve_gn_step(z, z, z, jnp.zeros(50), damping=1e-6)
    np.testing.assert_array_equal(np.asarray(xi), 0.0)


def _make_problem(seed=0, n_model=512, n_scene=800, noise=0.0):
    mesh = meshio.make_test_object("ellipsoid")
    mp, mn = mesh.sample_surface(n_model, seed=seed)
    sp_model, sn_model = mesh.sample_surface(n_scene, seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    T_gt = np.asarray(
        se3.se3_exp(jnp.asarray([0.4, -0.3, 0.2, 0.05, -0.02, 0.55], jnp.float32))
    )
    sp = sp_model @ T_gt[:3, :3].T + T_gt[:3, 3]
    sn = sn_model @ T_gt[:3, :3].T
    if noise:
        sp = sp + rng.normal(size=sp.shape) * noise
    return (
        jnp.asarray(mp), jnp.asarray(mn),
        jnp.asarray(sp, jnp.float32), jnp.asarray(sn, jnp.float32),
        jnp.asarray(T_gt, jnp.float32),
    )


def test_icp_converges_from_perturbation():
    """Config 1: 30-iter ICP recovers a perturbed pose on a synthetic frame.
    Error must fall well below 1mm ADD-S (BASELINE.md target)."""
    mp, mn, sp, sn, T_gt = _make_problem()
    T0 = se3.perturb_pose(jax.random.key(0), T_gt, 0.15, 0.02)
    w = jnp.ones(sp.shape[0])
    T, stats = icp.icp(
        T0, sp, sn, w, mp, mn, iters=30, max_corresp_dist=0.05, damping=1e-6
    )
    err = float(se3.add_s_error(T, T_gt, mp))
    assert err < 5e-4, err  # < 0.5 mm
    assert float(stats.rmse) < 2e-3


def test_icp_with_noise_and_padding():
    mp, mn, sp, sn, T_gt = _make_problem(noise=0.001)
    # pad scene with garbage points at weight 0
    pad = jnp.full((200, 3), 1e6)
    spp = jnp.concatenate([sp, pad])
    snp = jnp.concatenate([sn, jnp.zeros((200, 3))])
    w = jnp.concatenate([jnp.ones(sp.shape[0]), jnp.zeros(200)])
    T0 = se3.perturb_pose(jax.random.key(1), T_gt, 0.1, 0.015)
    T, stats = icp.icp(T0, spp, snp, w, mp, mn, iters=30, max_corresp_dist=0.05)
    err = float(se3.add_s_error(T, T_gt, mp))
    assert err < 2e-3, err
    assert float(stats.inliers) <= sp.shape[0] + 1e-3  # padding never counted


def test_icp_batched_matches_loop():
    """Config 2 consistency: vmapped refine == python loop over particles."""
    mp, mn, sp, sn, T_gt = _make_problem()
    w = jnp.ones(sp.shape[0])
    keys = jax.random.split(jax.random.key(2), 8)
    T0s = jnp.stack([se3.perturb_pose(k, T_gt, 0.1, 0.01) for k in keys])
    Tb, sb = icp.icp_batched(T0s, sp, sn, w, mp, mn, iters=10, max_corresp_dist=0.05)
    for i in range(8):
        Ti, si = icp.icp(T0s[i], sp, sn, w, mp, mn, iters=10, max_corresp_dist=0.05)
        np.testing.assert_allclose(np.asarray(Tb[i]), np.asarray(Ti), atol=5e-4)
        np.testing.assert_allclose(float(sb.rmse[i]), float(si.rmse), atol=1e-4)


def test_icp_best_hypothesis_selection():
    """The well-initialized particle must end with lower rmse than a bad one."""
    mp, mn, sp, sn, T_gt = _make_problem()
    w = jnp.ones(sp.shape[0])
    good = se3.perturb_pose(jax.random.key(3), T_gt, 0.05, 0.005)
    bad = se3.make_pose(jnp.eye(3), se3.translation(T_gt) + jnp.asarray([0.4, 0.4, 0.4]))
    Tb, stats = icp.icp_batched(
        jnp.stack([good, bad]), sp, sn, w, mp, mn, iters=20, max_corresp_dist=0.05
    )
    # rank by (inliers desc, rmse asc): good particle wins
    assert float(stats.inliers[0]) > float(stats.inliers[1]) or float(
        stats.rmse[0]
    ) < float(stats.rmse[1])
    err = float(se3.add_s_error(Tb[0], T_gt, mp))
    assert err < 1e-3


def test_icp_jits_and_is_deterministic():
    mp, mn, sp, sn, T_gt = _make_problem()
    w = jnp.ones(sp.shape[0])
    T0 = se3.perturb_pose(jax.random.key(4), T_gt, 0.1, 0.01)
    f = jax.jit(
        lambda t: icp.icp(t, sp, sn, w, mp, mn, iters=5, max_corresp_dist=0.05)[0]
    )
    a = np.asarray(f(T0))
    b = np.asarray(f(T0))
    np.testing.assert_array_equal(a, b)


def test_scene_support_separates_truth_from_slide():
    """Observation-side support (the scene-coverage fitness term): a pose
    explaining the whole observed cloud scores ~1; a pose slid by half an
    object length leaves a large fraction of observed points unexplained.
    This is the r3-measured global-init failure mode (a box slid ~48 mm
    along its axis reached full render-and-compare coverage and OUT-SCORED
    truth; its scene support was 0.57 vs truth's 0.99)."""
    mp, mn, sp, sn, T_gt = _make_problem()
    w = jnp.ones(sp.shape[0])
    slid = np.asarray(T_gt).copy()
    slid[:3, 3] += slid[:3, :3] @ np.asarray([0.0, 0.0, 0.05], np.float32)
    poses = jnp.stack([jnp.asarray(T_gt), jnp.asarray(slid)])
    supp = icp.scene_support(poses, sp, w, mp, tau=0.01)
    assert float(supp[0]) > 0.95
    assert float(supp[1]) < 0.8
    # weighted: zeroed points must not count
    w2 = w.at[: sp.shape[0] // 2].set(0.0)
    supp_w = icp.scene_support(poses, sp, w2, mp, tau=0.01)
    assert float(supp_w[0]) > 0.95


def test_icp_batched_support_matches_scene_support():
    """IcpStats.support (the free in-loop byproduct) must agree with an
    explicit scene_support call at the converged poses (the byproduct is
    at most one GN step stale; at convergence the step is ~0)."""
    mp, mn, sp, sn, T_gt = _make_problem()
    w = jnp.ones(sp.shape[0])
    keys = jax.random.split(jax.random.key(5), 4)
    T0s = jnp.stack([se3.perturb_pose(k, T_gt, 0.08, 0.008) for k in keys])
    Tb, stats = icp.icp_batched(
        T0s, sp, sn, w, mp, mn, iters=15, max_corresp_dist=0.05,
        support_tau=0.01,
    )
    explicit = icp.scene_support(Tb, sp, w, mp, tau=0.01)
    np.testing.assert_allclose(
        np.asarray(stats.support), np.asarray(explicit), atol=0.02
    )
    # support_tau=0 keeps the field all-zeros (disabled path)
    _, stats0 = icp.icp_batched(
        T0s, sp, sn, w, mp, mn, iters=5, max_corresp_dist=0.05
    )
    np.testing.assert_array_equal(np.asarray(stats0.support), 0.0)
