"""Odometry-gated keyframe pipeline: the device step and the host loop."""

from vision_slam_frontend_tpu_torch.frontend.config import FrontendConfig
from vision_slam_frontend_tpu_torch.frontend.frontend import Frontend

__all__ = ["Frontend", "FrontendConfig"]
