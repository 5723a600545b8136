"""Device-ready object model.

Rebuild of the reference's per-object precompute (SURVEY.md §4.1:
PoseEstimator constructor loads the object mesh as a PCL cloud, builds a
KD-tree over the model, and keeps the mesh for rendering). Here
the model becomes three padded static tensors — an ICP cloud with
normals, a denser render-sample cloud for point-splat rasterization,
and the raw mesh kept host-side for exact triangle rendering of
synthetic ground truth.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils import meshio


class ObjectModel:
    """Static per-object tensors used by the estimator.

    model_pts/model_normals: [Nm,3] uniform surface samples (ICP target).
    render_pts/render_w:     [Nr,3]/[Nr] denser samples for depth splat.
    diameter:                mesh bounding diameter (meters), used to
                             scale ADD-S thresholds and search sigmas.
    """

    def __init__(
        self,
        mesh: meshio.Mesh,
        *,
        model_points: int = 1024,
        render_points: int = 2048,
        seed: int = 0,
    ):
        self.mesh = mesh
        p, n = mesh.sample_surface(model_points, seed=seed)
        self.model_pts = jnp.asarray(p, jnp.float32)
        self.model_normals = jnp.asarray(n, jnp.float32)
        rp, rn = mesh.sample_surface(render_points, seed=seed + 1)
        self.render_pts = jnp.asarray(rp, jnp.float32)
        self.render_normals = jnp.asarray(rn, jnp.float32)
        self.render_w = jnp.ones((render_points,), jnp.float32)
        self.diameter = float(mesh.diameter())
        self.centroid = np.asarray(mesh.centroid(), np.float32)
        # [S,4,4] discrete symmetry group (identity alone when trivial /
        # unknown): rides obj_tensors into the frame program so the
        # tracker can snap its reported pose to the prior's symmetry
        # branch (ops/pso.snap_to_branch) — an exact-symmetry twin
        # renders an IDENTICAL depth image, so which branch is reported
        # is pure convention; the snap makes it the temporally-stable one.
        sym = getattr(mesh, "symmetries", None)
        self.symmetries = jnp.asarray(
            np.eye(4, dtype=np.float32)[None] if sym is None
            else np.asarray(sym, np.float32)
        )

    @classmethod
    def load(cls, path: str, **kwargs) -> "ObjectModel":
        """Load a .obj/.ply mesh file (the reference's model library entry
        point, SURVEY.md §1 item 7)."""
        return cls(meshio.load_mesh(path), **kwargs)
