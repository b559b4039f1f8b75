"""Frontend configuration + stereo rig calibration (port of frontend/config.py).

Same fields, defaults and derived matrices as the JAX package's
FrontendConfig, computed with numpy, so the port runs where JAX is not
installed. Options whose code is not ported yet raise NotImplementedError.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any

import numpy as np

from vision_slam_frontend_tpu_torch.geometry.camera import (
    Intrinsics,
    camera_matrix,
    fundamental_from_stereo,
)
from vision_slam_frontend_tpu_torch.ops.descriptors import get_family

# Campus-Jackal Point Grey rig (the JAX package's DEFAULT_CALIB).
DEFAULT_CALIB = {
    "intrinsics_left": {
        "fx": 527.873518, "fy": 527.276819, "cx": 482.823413, "cy": 298.033945,
        "k1": -0.153137, "k2": 0.075666, "p1": -0.000227, "p2": -0.000320, "k3": 0.0,
    },
    "intrinsics_right": {
        "fx": 530.158021, "fy": 529.682234, "cx": 475.540633, "cy": 299.995465,
        "k1": -0.156833, "k2": 0.081841, "p1": -0.000779, "p2": -0.000356, "k3": -0.000779,
    },
    # Right camera extrinsic block A = [R | t]: x_right = R x_left + t.
    "right_extrinsic": [
        [0.999593617649873, 0.021411909431148, -0.018818333830411, -0.131707087331978],
        [-0.021140534893290, 0.999671312094879, 0.014503294761121, 0.003232397463343],
        [0.019122691705565, -0.014099571235136, 0.999717722536176, -0.001146108483477],
    ],
    # Left camera -> robot frame transform.
    "left_cam_to_robot_translation": [-0.01, 0.06, 0.5299999713897705],
    "left_cam_to_robot_rotation": [
        [0.009916590468, -0.2835522866, 0.9589055021],
        [-0.9998698619, -0.01501486552, 0.005900269087],
        [0.01272480238, -0.9588392225, -0.2836642819],
    ],
}


@dataclasses.dataclass
class FrontendConfig:
    """All frontend knobs + derived stereo geometry (see the JAX package's
    FrontendConfig for what each knob does)."""

    # --- pipeline parameters ---
    best_percent: float = 0.3
    nn_match_ratio: float = 0.6
    min_odom_translation: float = 0.2           # metres
    min_odom_rotation: float = 10.0 * np.pi / 180.0  # radians
    min_vision_matches: int = 10                # kept for parity; unused, as in the reference
    frame_life: int = 10                        # temporal window W
    fast_threshold: float = 10.0
    stereo_threshold_init: float = 10000.0      # adaptive epipolar gate seed
    stereo_threshold_padding: float = 2.0       # running-average padding
    debug_images: bool = False                  # not ported yet
    validate: bool = False                      # not ported yet
    mutual_check: bool = True                   # one-to-one temporal matching
    guided_match_radius: float = 40.0           # px; <= 0 disables the guided gate

    descriptor_family: str = "orb"

    # --- capacities (fixed shapes) ---
    max_features: int = 512                     # K: per-frame feature capacity
    blur_sigma: float = 2.0
    detect_border: int = 19                     # PATCH_RADIUS + 4
    num_levels: int = 1                         # pyramid levels; only 1 is ported
    pyramid_scale: float = 1.4

    # --- calibration ---
    calib: dict = dataclasses.field(default_factory=lambda: copy.deepcopy(DEFAULT_CALIB))

    # --- derived (filled by __post_init__) ---
    intrinsics_left: Any = dataclasses.field(init=False, default=None)
    intrinsics_right: Any = dataclasses.field(init=False, default=None)
    K_left: Any = dataclasses.field(init=False, default=None)
    K_right: Any = dataclasses.field(init=False, default=None)
    P_left: Any = dataclasses.field(init=False, default=None)
    P_right: Any = dataclasses.field(init=False, default=None)
    fundamental: Any = dataclasses.field(init=False, default=None)
    left_cam_to_robot: Any = dataclasses.field(init=False, default=None)  # 4x4 numpy

    def __post_init__(self):
        get_family(self.descriptor_family)
        for name, asked in (
            ("num_levels > 1 (image pyramid)", self.num_levels != 1),
            ("debug_images", self.debug_images),
            ("validate", self.validate),
        ):
            if asked:
                raise NotImplementedError(f"FrontendConfig option {name} is not ported yet")
        c = self.calib
        self.intrinsics_left = Intrinsics.create(**c["intrinsics_left"])
        self.intrinsics_right = Intrinsics.create(**c["intrinsics_right"])
        K_l = camera_matrix(self.intrinsics_left)
        K_r = camera_matrix(self.intrinsics_right)
        A_r = np.asarray(c["right_extrinsic"], np.float32)  # (3, 4)
        R, t = A_r[:, :3], A_r[:, 3]
        self.K_left, self.K_right = K_l, K_r
        self.P_left = (K_l @ np.hstack([np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)])).astype(np.float32)
        self.P_right = (K_r @ A_r).astype(np.float32)
        self.fundamental = fundamental_from_stereo(K_l, K_r, R, t).astype(np.float32)
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = np.asarray(c["left_cam_to_robot_rotation"], np.float32)
        m[:3, 3] = np.asarray(c["left_cam_to_robot_translation"], np.float32)
        self.left_cam_to_robot = m

    @classmethod
    def load(cls, path: str) -> "FrontendConfig":
        """Load config + calibration from YAML; missing keys keep defaults."""
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        calib = data.pop("calib", None) or copy.deepcopy(DEFAULT_CALIB)
        fields = {f.name for f in dataclasses.fields(cls) if f.init}
        known = {k: v for k, v in data.items() if k in fields}
        unknown = set(data) - set(known)
        if unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        return cls(calib=calib, **known)
