"""Separable one-hot matmul image gather (ops/gather_mxu) vs jnp.take oracle.

The gather replacement must be exact to double-bf16 precision (~3 um at
0.5 m) or the coarse-tier fitness field changes and the swarm behaves
differently; these tests pin value agreement, out-of-range semantics,
and full compare_points score agreement between gather_mode paths.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from icra20_hand_object_pose_tpu.ops import gather_mxu, score


def _image(key, H, W):
    """Depth-like image with sentinel classes mixed in."""
    d = jax.random.uniform(key, (H, W), jnp.float32, 0.3, 1.5)
    k1, k2 = jax.random.split(key)
    cls = jax.random.uniform(k1, (H, W))
    d = jnp.where(cls < 0.1, score._FAR, d)
    d = jnp.where(cls > 0.9, score._NEAR, d)
    return d


def test_take_image_matches_take():
    H, W = 60, 80
    img = _image(jax.random.key(0), H, W)
    hi, lo = gather_mxu.split_bf16(img)
    k = jax.random.key(1)
    vi = jax.random.randint(k, (3, 257), 0, H, jnp.int32)
    ui = jax.random.randint(jax.random.fold_in(k, 1), (3, 257), 0, W, jnp.int32)
    got = np.asarray(gather_mxu.take_image(hi, lo, vi, ui))
    want = np.asarray(img)[np.asarray(vi), np.asarray(ui)]
    # double-bf16: ~16 mantissa bits -> relative error < 2^-15
    assert np.allclose(got, want, rtol=4e-5), np.abs(got - want).max()


def test_take_image_out_of_range_is_zero():
    img = _image(jax.random.key(2), 16, 24)
    hi, lo = gather_mxu.split_bf16(img)
    vi = jnp.asarray([-1, 0, 16, 5], jnp.int32)
    ui = jnp.asarray([3, -1, 3, 24], jnp.int32)
    got = np.asarray(gather_mxu.take_image(hi, lo, vi, ui))
    assert np.all(got == 0.0)


def test_take_image_corners_matches_quad():
    """Corner fetch must agree with the pack_quad gather path, including
    the border (-1 / H-1) rows the _FAR padding used to cover — the one-hot
    path returns 0.0 there, which the masks treat identically (invalid);
    compare only the in-range corners for value equality."""
    H, W = 40, 48
    img = _image(jax.random.key(3), H, W)
    hi, lo = gather_mxu.split_bf16(img)
    k = jax.random.key(4)
    v0 = jax.random.randint(k, (129,), 0, H - 1, jnp.int32)
    u0 = jax.random.randint(jax.random.fold_in(k, 1), (129,), 0, W - 1, jnp.int32)
    d00, d01, d10, d11 = [
        np.asarray(c) for c in gather_mxu.take_image_corners(hi, lo, v0, u0)
    ]
    ref = np.asarray(img)
    v0n, u0n = np.asarray(v0), np.asarray(u0)
    assert np.allclose(d00, ref[v0n, u0n], rtol=4e-5)
    assert np.allclose(d01, ref[v0n, u0n + 1], rtol=4e-5)
    assert np.allclose(d10, ref[v0n + 1, u0n], rtol=4e-5)
    assert np.allclose(d11, ref[v0n + 1, u0n + 1], rtol=4e-5)


def test_patch_lookup_matches_image_lookup():
    """Patch-local lookups must equal full-image lookups for samples
    inside their patches, and read 0.0 outside."""
    H, W, S, N = 64, 96, 16, 33
    img = _image(jax.random.key(7), H, W)
    hi, lo = gather_mxu.split_bf16(img)
    k = jax.random.key(8)
    # reference projections well inside the image
    vr = jax.random.randint(k, (N,), S, H - S, jnp.int32)
    ur = jax.random.randint(jax.random.fold_in(k, 1), (N,), S, W - S, jnp.int32)
    pv0 = jnp.clip(vr - S // 2, 0, H - S)
    pu0 = jnp.clip(ur - S // 2, 0, W - S)
    p_hi = gather_mxu.extract_patches(hi, pv0, pu0, S)
    p_lo = gather_mxu.extract_patches(lo, pv0, pu0, S)
    # in-patch offsets
    dv = jax.random.randint(jax.random.fold_in(k, 2), (5, N), -S // 2, S // 2)
    du = jax.random.randint(jax.random.fold_in(k, 3), (5, N), -S // 2, S // 2)
    vi, ui = vr[None] + dv, ur[None] + du
    got = np.asarray(gather_mxu.take_patches(p_hi, p_lo, vi - pv0, ui - pu0))
    want = np.asarray(img)[np.asarray(vi), np.asarray(ui)]
    assert np.allclose(got, want, rtol=4e-5)
    # corners too
    c = gather_mxu.take_patch_corners(
        p_hi, p_lo, vi - pv0, ui - pu0)
    ref = np.asarray(img)
    vin, uin = np.asarray(vi), np.asarray(ui)
    inb1 = (vin + 1 - np.asarray(pv0)[None] < S) & (uin + 1 - np.asarray(pu0)[None] < S)
    assert np.allclose(np.asarray(c[0]), ref[vin, uin], rtol=4e-5)
    d11 = np.asarray(c[3])
    assert np.allclose(d11[inb1], ref[vin + 1, uin + 1][inb1], rtol=4e-5)
    # out-of-patch reads exactly 0
    far = np.asarray(gather_mxu.take_patches(
        p_hi, p_lo, vi - pv0 + S, ui - pu0))
    assert np.all(far == 0.0)


@pytest.mark.parametrize("subpixel", [False, True])
def test_compare_points_patch_mode_agrees_with_take(subpixel):
    """Finisher-tier patch mode must reproduce take-path ScoreTerms for
    particles perturbed by millimeters around the reference pose (the
    regime the finisher operates in)."""
    H, W = 120, 160
    fx = fy = 140.0
    cx, cy = W / 2, H / 2
    key = jax.random.key(9)
    depth = jax.random.uniform(key, (H, W), jnp.float32, 0.4, 0.6)
    valid = jax.random.uniform(jax.random.fold_in(key, 1), (H, W)) > 0.15
    depth = jnp.where(valid, depth, 0.0)
    hand = jnp.where(
        jax.random.uniform(jax.random.fold_in(key, 2), (H, W)) > 0.8,
        0.35, jnp.inf)

    P, N, S = 6, 128, 16
    base = jax.random.uniform(
        jax.random.fold_in(key, 3), (N, 3), jnp.float32, -0.06, 0.06)
    base = base.at[..., 2].add(0.5)
    # mm-scale per-particle offsets (the finisher regime)
    off = jax.random.uniform(
        jax.random.fold_in(key, 4), (P, 1, 3), jnp.float32, -0.003, 0.003)
    pts = base[None] + off
    nrm = jax.random.normal(jax.random.fold_in(key, 5), (P, N, 3))
    nrm = nrm / jnp.linalg.norm(nrm, axis=-1, keepdims=True)

    enc = score.encode_observed(depth, valid, 1)
    hand_sent = jnp.where(jnp.isfinite(hand), hand, score._FAR)
    e_hi, e_lo = gather_mxu.split_bf16(enc)
    g_hi, g_lo = gather_mxu.split_bf16(hand_sent)
    zr = base[..., 2]
    ur = jnp.round(base[..., 0] / zr * fx + cx).astype(jnp.int32)
    vr = jnp.round(base[..., 1] / zr * fy + cy).astype(jnp.int32)
    pu0 = jnp.clip(ur - S // 2, 0, W - S)
    pv0 = jnp.clip(vr - S // 2, 0, H - S)
    patches = tuple(gather_mxu.extract_patches(t, pv0, pu0, S)
                    for t in (e_hi, e_lo, g_hi, g_lo))
    mxu = ("patch", *patches, pv0, pu0)
    kw = dict(fx=fx, fy=fy, cx=cx, cy=cy, height=H, width=W,
              subpixel=subpixel, observed_enc=enc)
    a = score.compare_points(pts, nrm, depth, valid, hand, **kw)
    b = score.compare_points(pts, nrm, depth, valid, hand, **kw,
                             mxu_tables=mxu)
    np.testing.assert_allclose(
        np.asarray(a.fitness), np.asarray(b.fitness), rtol=0, atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(a.coverage), np.asarray(b.coverage), rtol=0, atol=2e-4)


@pytest.mark.parametrize("subpixel", [False, True])
def test_compare_points_mxu_agrees_with_take(subpixel):
    """Full scoring path: gather_mode='mxu' must reproduce the take-path
    ScoreTerms for a realistic particle batch (same classification of
    every sample, fitness equal to lookup precision)."""
    H, W = 120, 160
    fx = fy = 140.0
    cx, cy = W / 2, H / 2
    key = jax.random.key(5)
    depth = jax.random.uniform(key, (H, W), jnp.float32, 0.4, 0.6)
    valid = jax.random.uniform(jax.random.fold_in(key, 1), (H, W)) > 0.15
    depth = jnp.where(valid, depth, 0.0)
    hand = jnp.where(
        jax.random.uniform(jax.random.fold_in(key, 2), (H, W)) > 0.8,
        0.35, jnp.inf)

    P, N = 8, 256
    pts = jax.random.uniform(
        jax.random.fold_in(key, 3), (P, N, 3), jnp.float32, -0.08, 0.08)
    pts = pts.at[..., 2].add(0.5)
    nrm = jax.random.normal(jax.random.fold_in(key, 4), (P, N, 3))
    nrm = nrm / jnp.linalg.norm(nrm, axis=-1, keepdims=True)

    enc = score.encode_observed(depth, valid, 1)
    hand_sent = jnp.where(jnp.isfinite(hand), hand, score._FAR)
    mxu = ("image", *gather_mxu.split_bf16(enc),
           *gather_mxu.split_bf16(hand_sent))
    kw = dict(fx=fx, fy=fy, cx=cx, cy=cy, height=H, width=W,
              subpixel=subpixel, observed_enc=enc)
    a = score.compare_points(pts, nrm, depth, valid, hand, **kw)
    b = score.compare_points(pts, nrm, depth, valid, hand, **kw,
                             mxu_tables=mxu)
    np.testing.assert_allclose(
        np.asarray(a.fitness), np.asarray(b.fitness), rtol=0, atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(a.coverage), np.asarray(b.coverage), rtol=0, atol=2e-4)
    np.testing.assert_allclose(
        np.asarray(a.counted), np.asarray(b.counted), rtol=0, atol=0.5)
