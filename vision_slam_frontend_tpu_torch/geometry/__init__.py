"""Quaternion, SE(3) and camera-model ops on tensors (the JAX package's
geometry exports)."""

from vision_slam_frontend_tpu_torch.geometry.camera import (
    camera_matrix,
    distort_points,
    epipolar_residual,
    fundamental_from_stereo,
    project_points,
    triangulate_points,
    undistort_points,
)
from vision_slam_frontend_tpu_torch.geometry.rotation import (
    axis_angle_to_matrix,
    axis_angle_to_quat,
    matrix_to_axis_angle,
    matrix_to_quat,
    quat_angular_distance,
    quat_conjugate,
    quat_identity,
    quat_inverse,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_axis_angle,
    quat_to_matrix,
)
from vision_slam_frontend_tpu_torch.geometry.se3 import (
    Pose3,
    pose_compose,
    pose_identity,
    pose_inverse,
    pose_relative,
    pose_transform_points,
)

__all__ = [
    "quat_identity",
    "quat_normalize",
    "quat_multiply",
    "quat_conjugate",
    "quat_inverse",
    "quat_rotate",
    "quat_to_matrix",
    "matrix_to_quat",
    "quat_to_axis_angle",
    "axis_angle_to_quat",
    "axis_angle_to_matrix",
    "matrix_to_axis_angle",
    "quat_angular_distance",
    "Pose3",
    "pose_identity",
    "pose_compose",
    "pose_inverse",
    "pose_relative",
    "pose_transform_points",
    "camera_matrix",
    "project_points",
    "distort_points",
    "undistort_points",
    "triangulate_points",
    "fundamental_from_stereo",
    "epipolar_residual",
]
