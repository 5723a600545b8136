"""Correspondence search (ops/knn.py): the fused brute-force search XLA
compiles, against a float64 brute force (SURVEY.md §8 hard part 2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from icra20_hand_object_pose_tpu.ops import icp, knn
from icra20_hand_object_pose_tpu.utils import meshio, se3


def rand_clouds(key, P, Ns, Nm, scale=0.3, shared=False):
    kq, kr, kn = jax.random.split(key, 3)
    q = jax.random.uniform(kq, (Ns, 3) if shared else (P, Ns, 3),
                           minval=-scale, maxval=scale)
    r = jax.random.uniform(kr, (P, Nm, 3), minval=-scale, maxval=scale)
    n = jax.random.normal(kn, (P, Nm, 3))
    return q, r, n


def brute_force(q, r):
    """float64 (idx, d2) of every query against every ref, [P,Ns]."""
    q64 = np.asarray(q, np.float64)
    r64 = np.asarray(r, np.float64)
    if q64.ndim == 2:
        q64 = np.broadcast_to(q64, (r64.shape[0],) + q64.shape)
    d = ((q64[:, :, None, :] - r64[:, None, :, :]) ** 2).sum(-1)
    return d.argmin(-1), d.min(-1)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("P,Ns,Nm", [(1, 64, 128), (2, 100, 200),
                                     (3, 256, 1024), (5, 37, 73)])
def test_matches_dense(P, Ns, Nm, shared):
    """Exact against brute force: index, distance and gathered
    attributes, for a shared scene and for per-particle queries."""
    q, r, n = rand_clouds(jax.random.key(0), P, Ns, Nm, shared=shared)
    matched, mnorm, d2, idx = jax.jit(knn.nn_gather_batched)(q, r, n)
    idx_ref, d2_ref = brute_force(q, r)
    np.testing.assert_array_equal(np.asarray(idx), idx_ref)
    np.testing.assert_allclose(np.asarray(d2), d2_ref, rtol=1e-5, atol=1e-9)
    np.testing.assert_array_equal(
        np.asarray(matched), np.take_along_axis(np.asarray(r),
                                                idx_ref[..., None], 1))
    np.testing.assert_array_equal(
        np.asarray(mnorm), np.take_along_axis(np.asarray(n),
                                              idx_ref[..., None], 1))


def test_padding_sentinel_never_wins():
    """Callers pad model clouds with far sentinel points (1e6): they must
    never be matched, and d2 stays finite and exact."""
    q, r, n = rand_clouds(jax.random.key(1), 2, 37, 73, shared=True)
    pad = jnp.full((2, 55, 3), 1e6, jnp.float32)
    _, _, d2, idx = knn.nn_gather_batched(q, jnp.concatenate([r, pad], 1),
                                          jnp.concatenate([n, pad], 1))
    assert int(jnp.max(idx)) < 73
    idx_ref, d2_ref = brute_force(q, r)
    np.testing.assert_array_equal(np.asarray(idx), idx_ref)
    np.testing.assert_allclose(np.asarray(d2), d2_ref, rtol=1e-5, atol=1e-9)


def test_exact_distances_value():
    """Hand-checkable tiny case."""
    q = jnp.asarray([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    r = jnp.asarray([[[0.0, 0.0, 0.1], [1.0, 0.0, 0.2], [5.0, 5.0, 5.0]]])
    idx, d2 = knn.nn_batched(q, r)
    np.testing.assert_array_equal(np.asarray(idx[0]), [0, 1])
    np.testing.assert_allclose(np.asarray(d2[0]), [0.01, 0.04], rtol=1e-5)
    i1, d1 = knn.nn(q, r[0])
    np.testing.assert_array_equal(np.asarray(i1), [0, 1])
    np.testing.assert_allclose(np.asarray(d1), [0.01, 0.04], rtol=1e-5)


def test_shared_query_batch():
    """query [Ns,3] + ref [P,Nm,3] == the query broadcast per particle."""
    q, r, n = rand_clouds(jax.random.key(3), 3, 50, 80, shared=True)
    shared = knn.nn_gather_batched(q, r, n)
    tiled = knn.nn_gather_batched(jnp.broadcast_to(q, (3, 50, 3)), r, n)
    for a, b in zip(shared, tiled):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("copies", [2, 3])
def test_ties_take_first_index(copies):
    """Duplicate model points resolve to the first index, as jnp.argmin
    does."""
    base = jax.random.uniform(jax.random.key(4), (40, 3))
    r = jnp.concatenate([base] * copies)[None]
    q = base[::3] + 1e-3
    idx, _ = knn.nn_batched(q, r)
    np.testing.assert_array_equal(np.asarray(idx[0]), np.arange(0, 40, 3))


def test_pairwise_sqdist_matches_float64():
    kq, kr = jax.random.split(jax.random.key(8))
    q = 0.5 + jax.random.uniform(kq, (70, 3), minval=-0.1, maxval=0.1)
    r = 0.5 + jax.random.uniform(kr, (90, 3), minval=-0.1, maxval=0.1)
    d = knn.pairwise_sqdist(q, r)
    q64, r64 = np.asarray(q, np.float64), np.asarray(r, np.float64)
    ref = ((q64[:, None] - r64[None]) ** 2).sum(-1)
    np.testing.assert_allclose(np.asarray(d), ref, rtol=1e-5, atol=1e-12)
    assert float(jnp.min(d)) >= 0.0


def _box_icp_case(seed):
    mesh = meshio.make_test_object("box")
    mpts, mnrm = mesh.sample_surface(128, seed=0)
    mpts, mnrm = jnp.asarray(mpts), jnp.asarray(mnrm)
    T_gt = se3.make_pose(jnp.eye(3), jnp.asarray([0.0, 0.0, 0.4]))
    scene = se3.transform_points(T_gt, mpts)
    snrm = se3.rotate_vectors(T_gt, mnrm)
    w = jnp.ones(scene.shape[0])
    keys = jax.random.split(jax.random.key(seed), 4)
    poses0 = jax.vmap(lambda k: se3.perturb_pose(k, T_gt, 0.05, 0.008))(keys)
    return poses0, scene, snrm, w, mpts, mnrm, T_gt


@pytest.mark.parametrize("gn_reps", [1, 3])
def test_icp_with_default_search(gn_reps):
    poses0, scene, snrm, w, mpts, mnrm, T_gt = _box_icp_case(6)
    refined, stats = icp.icp_batched(
        poses0, scene, snrm, w, mpts, mnrm, iters=10, gn_reps=gn_reps,
        max_corresp_dist=0.05, support_tau=0.03)
    errs = jax.vmap(lambda T: se3.add_error(T, T_gt, mpts))(refined)
    assert float(jnp.max(errs)) < 0.002, np.asarray(errs)
    assert float(jnp.min(stats.support)) > 0.9   # converged: explained


@pytest.mark.parametrize("tau", [0.002, 0.005, 0.02])
def test_scene_support(tau):
    """Support = weighted fraction of scene points within tau of the
    posed model: 1 at truth, the brute-force fraction for a slid pose,
    zero-weight points ignored."""
    _, scene, _, _, mpts, _, T_gt = _box_icp_case(0)
    slid = T_gt.at[:3, 3].add(jnp.asarray([0.0, 0.0, 0.06]))
    w = jnp.ones(scene.shape[0]).at[::2].set(0.0)
    supp = icp.scene_support(jnp.stack([T_gt, slid]), scene, w, mpts, tau=tau)
    np.testing.assert_allclose(float(supp[0]), 1.0)
    _, d2 = brute_force(scene, se3.transform_points(slid, mpts)[None])
    want = np.sum((d2[0] < tau ** 2) * np.asarray(w)) / float(jnp.sum(w))
    np.testing.assert_allclose(float(supp[1]), want, rtol=1e-6)
