"""SE(3) rigid transforms as (translation, quaternion) tensors (port of
geometry/se3.py). A Pose3 maps points from its local frame to the parent
frame: x_parent = R(q) x_local + t.
"""

from __future__ import annotations

import dataclasses

import torch

from vision_slam_frontend_tpu_torch.geometry.rotation import (
    quat_identity,
    quat_inverse,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
)


@dataclasses.dataclass
class Pose3:
    """Rigid transform: translation (..., 3) + unit quaternion (..., 4) [w, x, y, z]."""

    t: torch.Tensor  # (..., 3)
    q: torch.Tensor  # (..., 4)

    def as_matrix(self) -> torch.Tensor:
        """(..., 4, 4) homogeneous matrix."""
        top = torch.cat([quat_to_matrix(self.q), self.t[..., :, None]], dim=-1)
        bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
        return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def pose_identity(dtype: torch.dtype = torch.float32, device=None) -> Pose3:
    return Pose3(t=torch.zeros(3, dtype=dtype, device=device), q=quat_identity(dtype, device))


def pose_compose(a: Pose3, b: Pose3) -> Pose3:
    """a ∘ b: apply b first, then a."""
    return Pose3(t=a.t + quat_rotate(a.q, b.t), q=quat_normalize(quat_multiply(a.q, b.q)))


def pose_inverse(p: Pose3) -> Pose3:
    qi = quat_inverse(p.q)
    return Pose3(t=-quat_rotate(qi, p.t), q=qi)


def pose_relative(a: Pose3, b: Pose3) -> Pose3:
    """a^{-1} ∘ b, the odometry factor's math: translation
    R_a^{-1} (t_b - t_a) and rotation q_a^{-1} q_b, in a's frame."""
    qi = quat_inverse(a.q)
    return Pose3(t=quat_rotate(qi, b.t - a.t), q=quat_normalize(quat_multiply(qi, b.q)))


def pose_transform_points(p: Pose3, x: torch.Tensor) -> torch.Tensor:
    """Apply the pose to points (..., 3): local -> parent frame."""
    return quat_rotate(p.q, x) + p.t
