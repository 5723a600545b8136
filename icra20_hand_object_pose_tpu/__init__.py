"""icra20_hand_object_pose_tpu — occlusion-aware 6-DoF pose estimation
and tracking of objects grasped by adaptive hands, on a GPU.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the ICRA'20
system `wenbowen123/icra20-hand-object-pose` (depth preprocessing, hand
segmentation, point-to-plane ICP, depth render-and-compare with finger
occlusion masks, PSO hypothesis search, sequence tracking), redesigned
for an accelerator: one jit-compiled device program per frame, particles
as a batch axis, a fused brute-force correspondence search, jax.sharding
for multi-device sweeps. See SURVEY.md for the blueprint.
"""
from .utils.config import (
    CameraIntrinsics,
    EstimatorConfig,
    HandConfig,
    IcpConfig,
    PsoConfig,
    ScoreConfig,
    TrackerConfig,
    load_yaml,
)

__version__ = "0.1.0"

__all__ = [
    "CameraIntrinsics",
    "EstimatorConfig",
    "HandConfig",
    "IcpConfig",
    "PsoConfig",
    "ScoreConfig",
    "TrackerConfig",
    "load_yaml",
    "__version__",
]
