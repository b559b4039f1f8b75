"""SLAM problem containers (port of types/slam_types.py): the host side as
plain dataclasses over numpy, and the bundle-adjustment problem
(`BAProblem`) as a dataclass of fixed-capacity masked torch tensors.
Quaternions are [w, x, y, z]; a RobotPose maps robot-frame points into the
world frame.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np


@dataclasses.dataclass
class CameraExtrinsics:
    """Camera-to-robot transform: translation (3,) and rotation (3,) in
    scaled axis-angle form (the reference's slam_types.h:50-58)."""

    translation: np.ndarray  # (3,)
    rotation: np.ndarray  # (3,) scaled axis-angle


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


@dataclasses.dataclass
class SLAMNodeSolution:
    """Solution container a backend fills in: pose = [tx, ty, tz, ax, ay,
    az] with the rotation in scaled axis-angle (the reference's layout,
    without its +0.02 seed perturbation of pose[5])."""

    node_idx: int
    timestamp: float
    pose: np.ndarray  # (6,)
    inverse_depths: np.ndarray  # (num_features,)
    point_in_map: np.ndarray  # (num_features,) bool

    @classmethod
    def from_node(cls, node: SLAMNode) -> "SLAMNodeSolution":
        from vision_slam_frontend_tpu_torch.utils.np_geom import quat_to_axis_angle

        aa = quat_to_axis_angle(np.asarray(node.pose.angle, np.float32))
        nf = len(node.features)
        return cls(
            node_idx=node.node_idx,
            timestamp=node.timestamp,
            pose=np.concatenate([np.asarray(node.pose.loc, np.float64), aa.astype(np.float64)]),
            inverse_depths=np.ones(nf, np.float64),
            point_in_map=np.zeros(nf, bool),
        )


# Index fields: int64 tensors in the port (torch's gathers want int64), int32
# arrays in the JAX package's numpy form and npz files.
_INDEX_FIELDS = ("obs_pose", "obs_landmark", "odom_i", "odom_j", "pose_obs", "lm_obs")


def _field_dtype(name: str, dtype) -> np.dtype:
    """The numpy dtype a BAProblem field takes in the port: int64 for an
    index field, bool for a mask given as bool, float32 for the rest."""
    if name in _INDEX_FIELDS:
        return np.dtype(np.int64)
    return np.dtype(bool) if dtype == bool else np.dtype(np.float32)


@dataclasses.dataclass
class BAProblem:
    """Bundle-adjustment problem as flat, fixed-capacity masked tensors
    (port of the JAX package's BAProblem). Shapes:

      poses_t (P, 3), poses_q (P, 4) [w, x, y, z], pose_mask (P,)
      landmarks (L, 3), landmark_mask (L,)
      obs_pose, obs_landmark (N,) int64; obs_pixel (N, 2); obs_mask (N,)
      obs_pixel_right (N, 2), obs_right_mask (N,): the stereo constraint
      odom_i, odom_j (Q,) int64; odom_t (Q, 3), odom_q (Q, 4), odom_mask (Q,)

    Optional gather tables (backend/tracks.build_gather_tables): pose_obs
    (P, Mp) lists pose p's observations, lm_obs (L, Ml) landmark l's as
    positions in the pose-major flat (P*Mp) space, each with its mask. The
    solver's large reductions run as dense gathers + sums over them; None
    means scatter sums. pose_fixed (P,) bool freezes poses.
    """

    poses_t: Any
    poses_q: Any
    pose_mask: Any
    landmarks: Any
    landmark_mask: Any
    obs_pose: Any
    obs_landmark: Any
    obs_pixel: Any
    obs_mask: Any
    obs_pixel_right: Any = None
    obs_right_mask: Any = None
    odom_i: Any = None
    odom_j: Any = None
    odom_t: Any = None
    odom_q: Any = None
    odom_mask: Any = None
    pose_obs: Any = None
    pose_obs_mask: Any = None
    lm_obs: Any = None
    lm_obs_mask: Any = None
    pose_fixed: Any = None

    @property
    def num_poses(self) -> int:
        return self.poses_t.shape[0]

    @property
    def num_landmarks(self) -> int:
        return self.landmarks.shape[0]

    @property
    def num_observations(self) -> int:
        return self.obs_pixel.shape[0]

    @property
    def device(self):
        return self.poses_t.device

    def replace(self, **changes) -> "BAProblem":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "BAProblem":
        return self.replace(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if getattr(self, f.name) is not None
        })

    @classmethod
    def from_numpy(cls, arrays, device="cuda") -> "BAProblem":
        """Tensors on `device` (the GPU unless the caller names the CPU) from
        numpy arrays (a BAProblem of arrays, such as the JAX package's, or a
        dict of them): index fields as int64, masks as bool, the rest as
        float32. A CUDA upload goes through pinned memory and does not wait
        for the stream (a pageable one synchronizes it)."""
        import torch

        from vision_slam_frontend_tpu_torch.utils.device import resolve_device

        device = resolve_device(device)
        to_cuda = device.type == "cuda"

        if not isinstance(arrays, dict):
            arrays = {f.name: getattr(arrays, f.name) for f in dataclasses.fields(arrays)}
        out = {}
        for f in dataclasses.fields(cls):
            v = arrays.get(f.name)
            if v is None:
                continue
            a = np.asarray(v)
            t = torch.from_numpy(np.array(a.astype(_field_dtype(f.name, a.dtype)), order="C"))
            out[f.name] = (t.pin_memory() if to_cuda else t).to(device, non_blocking=to_cuda)
        return cls(**out)

    def to_numpy(self) -> dict:
        """{field: numpy array} in the JAX package's dtypes (index fields
        int32); None fields are left out."""
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            a = v.detach().cpu().numpy()
            out[f.name] = a.astype(np.int32) if f.name in _INDEX_FIELDS else a
        return out
