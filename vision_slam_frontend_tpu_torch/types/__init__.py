"""SLAM data model: the host-side problem containers and the BAProblem tensors."""

from vision_slam_frontend_tpu_torch.types.slam_types import (
    CameraExtrinsics,
    VisionFeature,
    FeatureMatch,
    VisionFactor,
    RobotPose,
    OdometryFactor,
    SLAMNode,
    SLAMProblem,
    SLAMNodeSolution,
    BAProblem,
)

__all__ = [
    "CameraExtrinsics",
    "VisionFeature",
    "FeatureMatch",
    "VisionFactor",
    "RobotPose",
    "OdometryFactor",
    "SLAMNode",
    "SLAMProblem",
    "SLAMNodeSolution",
    "BAProblem",
]
