"""Nearest-neighbor correspondence search.

Replaces the reference's PCL KdTreeFLANN per-point queries (SURVEY.md §3
"KD-tree NN correspondence") with a dense brute-force search: at the
sizes this pipeline runs (Ns <= 2048 scene points, Nm <= 1024 model
points) every query scans the whole model cloud.

Distances are formed by diff-square-accumulate over the three coordinates
and reduced by one (min, argmin) pass. The expression is elementwise up
to the reduction, so XLA fuses the distance producer into the reduction
and the [P,Ns,Nm] matrix is never written to device memory. It is exact
f32 arithmetic: no matmul, so no TF32 or bf16 rounding of a cross term
and no cancellation of the |q|^2 - 2 q.r + |r|^2 expansion.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def pairwise_sqdist(query: jax.Array, ref: jax.Array) -> jax.Array:
    """[...,N,3] x [...,M,3] -> [...,N,M] squared euclidean distances."""
    acc = None
    for c in range(3):
        d = query[..., :, None, c] - ref[..., None, :, c]
        acc = d * d if acc is None else acc + d * d
    return acc


def _min_argmin(d2: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(min, first argmin) over the last axis in one variadic reduction."""
    iota = jax.lax.broadcasted_iota(jnp.int32, d2.shape, d2.ndim - 1)

    def pick(a, b):
        (va, ia), (vb, ib) = a, b
        take_a = (va < vb) | ((va == vb) & (ia < ib))
        return jnp.where(take_a, va, vb), jnp.where(take_a, ia, ib)

    return jax.lax.reduce(
        (d2, iota), (jnp.asarray(jnp.inf, d2.dtype), jnp.int32(0)), pick,
        (d2.ndim - 1,),
    )


def nn_batched(query: jax.Array, ref: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Batched NN: query [Ns,3] (shared) or [P,Ns,3], ref [P,Nm,3].

    Returns (idx [P,Ns] int32, sqdist [P,Ns]). Ties resolve to the first
    minimal index, as jnp.argmin does.
    """
    d2, idx = _min_argmin(pairwise_sqdist(query, ref))
    return idx, d2


def nn(query: jax.Array, ref: jax.Array) -> tuple[jax.Array, jax.Array]:
    """Nearest neighbor of each query [N,3] in ref [M,3].

    Returns (idx [N] int32, sqdist [N]).
    """
    return nn_batched(query, ref)


def nn_gather_batched(
    query: jax.Array,        # [Ns,3] shared, or [P,Ns,3]
    ref_pts: jax.Array,      # [P,Nm,3]
    ref_normals: jax.Array,  # [P,Nm,3]
) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """NN search + gather of the matched point and normal.

    Returns (matched [P,Ns,3], matched normals [P,Ns,3], d2 [P,Ns],
    idx [P,Ns]).
    """
    idx, d2 = nn_batched(query, ref_pts)
    matched = jnp.take_along_axis(ref_pts, idx[..., None], axis=1)
    mnormal = jnp.take_along_axis(ref_normals, idx[..., None], axis=1)
    return matched, mnormal, d2, idx
