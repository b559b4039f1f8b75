"""SLAM problem containers on the host (port of the host side of
types/slam_types.py): plain dataclasses over numpy. Quaternions are
[w, x, y, z]; a RobotPose maps robot-frame points into the world frame.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np


@dataclasses.dataclass
class VisionFeature:
    """One observed feature in a node; `pixel_right` is the matched
    right-camera pixel of the stereo pair (None when unavailable)."""

    feature_idx: int
    pixel: np.ndarray  # (2,)
    point3d: np.ndarray  # (3,) estimated 3D point in the camera frame
    pixel_right: Any = None  # (2,) or None


@dataclasses.dataclass
class FeatureMatch:
    """Feature index pair between an initial and a current pose."""

    feature_idx_initial: int
    feature_idx_current: int


@dataclasses.dataclass
class VisionFactor:
    """Cross-frame feature correspondence set."""

    pose_idx_initial: int
    pose_idx_current: int
    feature_matches: List[FeatureMatch]


@dataclasses.dataclass
class RobotPose:
    """World-frame robot pose: loc (3,) + quaternion [w, x, y, z]."""

    loc: np.ndarray  # (3,)
    angle: np.ndarray  # (4,)


@dataclasses.dataclass
class OdometryFactor:
    """Relative pose from pose_i to pose_j, expressed in pose_i's frame."""

    pose_i: int
    pose_j: int
    translation: np.ndarray  # (3,)
    rotation: np.ndarray  # (4,) [w, x, y, z]


@dataclasses.dataclass
class SLAMNode:
    """One pose-graph node."""

    node_idx: int
    timestamp: float
    pose: RobotPose
    features: List[VisionFeature]


@dataclasses.dataclass
class SLAMProblem:
    """The frontend's output contract."""

    nodes: List[SLAMNode] = dataclasses.field(default_factory=list)
    vision_factors: List[VisionFactor] = dataclasses.field(default_factory=list)
    odometry_factors: List[OdometryFactor] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        """The end-of-run summary line, identical to the JAX package's."""
        n = len(self.nodes)
        return (
            "Saved SLAM problem with %d nodes, %d odometry factors, "
            "%d vision factors (%.2f/pose avg)"
            % (
                n,
                len(self.odometry_factors),
                len(self.vision_factors),
                (len(self.vision_factors) / (n - 1)) if n > 1 else 0.0,
            )
        )
