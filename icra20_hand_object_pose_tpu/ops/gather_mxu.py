"""Image gathers as separable one-hot matmuls (ScoreConfig.gather_mode="mxu").

Projective render-and-compare (ops/score.compare_points) classifies every
posed model sample by the observed/hand depth at its projected pixel — a
random image gather, ~5M of them per frame (two per sample per tier).
This module expresses each lookup at integer pixel (vi, ui) as the
bilinear form

    D[vi, ui] = onehot(vi) @ D @ onehot(ui)^T

i.e. two matmuls instead of a gather. On the H100 the plain gathers are
faster (the default `gather_mode="take"`; see PERF.md), so this path
is an alternative kept for comparison. For a batch of N samples over one
[H, W] image:

    E = V @ D            # [N,H] one-hot rows @ [H,W]  -> [N,W]
    d = sum(E * U, -1)   # row-wise dot with [N,W] one-hot

Lookups stay EXACT under bf16 matmuls because one operand is a one-hot
(products are 1.0 * value) — provided the VALUE operand is exact in
bf16, which f32 depths are not. The double-bf16 split (hi = bf16(x),
lo = bf16(x - hi)) carries ~16 mantissa
bits through two bf16 matmuls with f32 accumulation: worst-case lookup
error ~3 um at 0.5 m, far below every depth tolerance in the pipeline.

The bilinear (subpixel) variant returns all four corner values of the
2x2 cell exactly — the caller applies the same edge-aware combination
as the quad-gather path (score._bilinear_depth semantics), weights
never enter a matmul.

No Pallas needed: XLA fuses the iota-compare one-hot construction into
the matmul.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def split_bf16(x: jax.Array) -> tuple[jax.Array, jax.Array]:
    """f32 -> (hi, lo) bf16 pair with hi + lo ~= x to ~16 mantissa bits."""
    hi = x.astype(jnp.bfloat16)
    lo = (x - hi.astype(x.dtype)).astype(jnp.bfloat16)
    return hi, lo


def _onehot(idx: jax.Array, n: int) -> jax.Array:
    """[...,1]-vs-iota one-hot rows, bf16 (exact 0/1). Out-of-range rows
    are all-zero -> lookup returns 0.0 (callers treat 0 as invalid)."""
    iota = jax.lax.iota(jnp.int32, n)
    return (idx[..., None] == iota).astype(jnp.bfloat16)


def take_image(
    table_hi: jax.Array,   # [H,W] bf16 (split_bf16 of the f32 image)
    table_lo: jax.Array,   # [H,W] bf16
    vi: jax.Array,         # [...,N] int32 row indices
    ui: jax.Array,         # [...,N] int32 col indices
) -> jax.Array:
    """f32 image values at integer pixels via separable one-hot matmuls.

    Out-of-range (vi, ui) return exactly 0.0. Equivalent to
    `jnp.take(img.reshape(-1), vi * W + ui)` for in-range indices
    (to double-bf16 precision); callers keep their own in-bounds masks.
    """
    H, W = table_hi.shape
    V = _onehot(vi, H)                                  # [...,N,H]
    U = _onehot(ui, W)                                  # [...,N,W]
    e = jnp.einsum(
        "...nh,hw->...nw", V, table_hi,
        preferred_element_type=jnp.float32,
    ) + jnp.einsum(
        "...nh,hw->...nw", V, table_lo,
        preferred_element_type=jnp.float32,
    )
    return jnp.sum(e * U.astype(jnp.float32), axis=-1)


def extract_patches(
    img: jax.Array,        # [H,W] bf16 (one half of a split_bf16 pair)
    pv0: jax.Array,        # [N] int32 patch row origins (pre-clamped)
    pu0: jax.Array,        # [N] int32 patch col origins
    size: int,
) -> jax.Array:
    """[N, size, size] per-point patches via vmapped dynamic_slice.

    The finisher's score-only climb perturbs poses by millimeters around
    one reference pose, so every sample's projection stays within a few
    pixels of its reference projection across ALL finisher iterations —
    a [size,size] patch per REFERENCE sample, extracted once, turns each
    in-iteration image lookup into a tiny [*,size]@[size,size] one-hot
    matmul instead of a full-image gather (or a full-image one-hot whose
    [N_samples, H] operand would be GBs at VGA). dynamic_slice clamps
    starts internally; callers pre-clamp so local coordinates match.
    """
    return jax.vmap(
        lambda v0, u0: jax.lax.dynamic_slice(img, (v0, u0), (size, size))
    )(pv0, pu0)


def take_patches(
    p_hi: jax.Array,       # [N,S,S] bf16 per-point patches
    p_lo: jax.Array,       # [N,S,S] bf16
    v_loc: jax.Array,      # [...,N] int32 patch-local row
    u_loc: jax.Array,      # [...,N] int32 patch-local col
) -> jax.Array:
    """f32 patch values at integer local pixels; out-of-patch -> 0.0.

    Semantics match take_image with the patch as the world: a sample
    that drifted outside its reference patch reads 0.0 = "no evidence"
    (neither support, wrong-side, nor ghost) — acceptable because the
    finisher's mm-scale perturbations keep real candidates well inside.
    """
    S = p_hi.shape[-1]
    # operands cast to f32 but stay bf16-REPRESENTABLE (one-hots are
    # exact 0/1, patches are bf16 halves), so a DEFAULT-precision (TF32
    # on the GPU) matmul loses nothing — and the f32 dtype keeps the
    # batched dot on a kernel the CPU backend supports (its bf16 x bf16
    # = f32 DotThunk is unimplemented, which the virtual-device test
    # mesh would hit)
    V = _onehot(v_loc, S).astype(jnp.float32)           # [...,N,S]
    U = _onehot(u_loc, S).astype(jnp.float32)
    e = jnp.einsum(
        "...nh,nhw->...nw", V, p_hi.astype(jnp.float32),
        preferred_element_type=jnp.float32,
    ) + jnp.einsum(
        "...nh,nhw->...nw", V, p_lo.astype(jnp.float32),
        preferred_element_type=jnp.float32,
    )
    return jnp.sum(e * U, axis=-1)


def take_patch_corners(
    p_hi: jax.Array,       # [N,S,S] bf16
    p_lo: jax.Array,       # [N,S,S] bf16
    v0_loc: jax.Array,     # [...,N] int32 patch-local floor row
    u0_loc: jax.Array,     # [...,N] int32 patch-local floor col
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Four bilinear-cell corner values from per-point patches (the
    patch analogue of take_image_corners; same 0.0 out-of-range rule)."""
    S = p_hi.shape[-1]
    V0 = _onehot(v0_loc, S).astype(jnp.float32)
    V1 = _onehot(v0_loc + 1, S).astype(jnp.float32)
    U0 = _onehot(u0_loc, S).astype(jnp.float32)
    U1 = _onehot(u0_loc + 1, S).astype(jnp.float32)
    ph = p_hi.astype(jnp.float32)   # bf16-representable in f32; see
    pl = p_lo.astype(jnp.float32)   # take_patches for why

    def rows(V):
        return jnp.einsum(
            "...nh,nhw->...nw", V, ph,
            preferred_element_type=jnp.float32,
        ) + jnp.einsum(
            "...nh,nhw->...nw", V, pl,
            preferred_element_type=jnp.float32,
        )

    e0 = rows(V0)
    e1 = rows(V1)
    return (jnp.sum(e0 * U0, -1), jnp.sum(e0 * U1, -1),
            jnp.sum(e1 * U0, -1), jnp.sum(e1 * U1, -1))


def take_image_corners(
    table_hi: jax.Array,   # [H,W] bf16
    table_lo: jax.Array,   # [H,W] bf16
    v0: jax.Array,         # [...,N] int32 floor row (cell top)
    u0: jax.Array,         # [...,N] int32 floor col (cell left)
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """The four corner values (d00, d01, d10, d11) of the 2x2 bilinear
    cell at (v0, u0), each exact (one-hot selected, no interpolation in
    the matmul). djk = image[v0 + j, u0 + k]; out-of-range corners are
    0.0 — same semantics as the _FAR border of score.pack_quad, whose
    quad-gather path this replaces (invalid corners are masked by the
    caller's d > 0 test).
    """
    H, W = table_hi.shape
    V0 = _onehot(v0, H)
    V1 = _onehot(v0 + 1, H)
    U0 = _onehot(u0, W).astype(jnp.float32)
    U1 = _onehot(u0 + 1, W).astype(jnp.float32)

    def rows(V):
        return jnp.einsum(
            "...nh,hw->...nw", V, table_hi,
            preferred_element_type=jnp.float32,
        ) + jnp.einsum(
            "...nh,hw->...nw", V, table_lo,
            preferred_element_type=jnp.float32,
        )

    e0 = rows(V0)                                       # [...,N,W]
    e1 = rows(V1)
    d00 = jnp.sum(e0 * U0, axis=-1)
    d01 = jnp.sum(e0 * U1, axis=-1)
    d10 = jnp.sum(e1 * U0, axis=-1)
    d11 = jnp.sum(e1 * U1, axis=-1)
    return d00, d01, d10, d11
