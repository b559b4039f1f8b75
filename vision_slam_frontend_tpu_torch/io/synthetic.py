"""Synthetic stereo sequence generator: the port's self-contained input.

A copy of the JAX package's io/synthetic.py (the stereo world part; the
bundle-adjustment problem generator is not ported), so the port runs where
the JAX package is not installed. A deterministic textured tilted ground
plane rendered through the exact pinhole model, with ground-truth trajectory
and depth; the same seed gives the same frames, bit for bit, as the JAX
package's module (tests/test_torch_isolation.py).

All rendering is vectorized numpy on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

from vision_slam_frontend_tpu_torch.utils import np_geom


def make_texture(seed: int = 0, size: int = 1024, noise: float = 2.0) -> np.ndarray:
    """High-contrast random-rectangle texture with micro-texture noise
    (corner-rich). `noise` is the per-texel sigma: real surfaces (asphalt,
    gravel, grass) carry several-intensity-unit micro-texture; the 2.0
    default keeps historical fixtures, the golden-loop fixture uses a
    realistic 6.0 so descriptor families aren't graded on sub-quantization
    signal no 8-bit camera can deliver."""
    rng = np.random.default_rng(seed)
    tex = np.full((size, size), 120.0, np.float32)
    for _ in range(size):
        y, x = rng.integers(0, size - 32, 2)
        h, w = rng.integers(6, 32, 2)
        tex[y : y + h, x : x + w] = rng.uniform(10, 245)
    tex += rng.normal(0, noise, tex.shape).astype(np.float32)
    return np.clip(tex, 0, 255)


@dataclasses.dataclass
class SyntheticRig:
    """A simple stereo rig: identical pinhole cameras, pure-x baseline, no
    distortion. `calib()` returns a FrontendConfig-compatible calib dict."""

    fx: float = 500.0
    fy: float = 500.0
    cx: float = 320.0
    cy: float = 240.0
    baseline: float = 0.12
    width: int = 640
    height: int = 480

    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0, self.cx], [0, self.fy, self.cy], [0, 0, 1]], np.float32
        )

    def calib(self) -> dict:
        zero_dist = dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
        intr = dict(fx=self.fx, fy=self.fy, cx=self.cx, cy=self.cy, **zero_dist)
        return {
            "intrinsics_left": dict(intr),
            "intrinsics_right": dict(intr),
            # x_right = x_left + [-baseline, 0, 0]
            "right_extrinsic": [
                [1.0, 0.0, 0.0, -self.baseline],
                [0.0, 1.0, 0.0, 0.0],
                [0.0, 0.0, 1.0, 0.0],
            ],
            "left_cam_to_robot_translation": [0.0, 0.0, 0.0],
            "left_cam_to_robot_rotation": [
                [1.0, 0.0, 0.0],
                [0.0, 1.0, 0.0],
                [0.0, 0.0, 1.0],
            ],
        }


@dataclasses.dataclass
class PlaneScene:
    """A textured plane: point p0, unit normal n, in-plane axes e1/e2."""

    texture: np.ndarray
    p0: np.ndarray  # (3,)
    n: np.ndarray  # (3,) unit
    e1: np.ndarray  # (3,) unit, in-plane
    e2: np.ndarray  # (3,) unit, in-plane
    scale: float  # metres per full texture extent

    @classmethod
    def ground(cls, texture: np.ndarray, height: float = 1.4, tilt: float = 0.10, scale: float = 40.0):
        """Camera-below ground plane (y-down camera convention), slightly
        tilted so depth varies and the scene is non-degenerate."""
        n = np.array([0.0, -1.0, tilt])
        n = n / np.linalg.norm(n)
        e1 = np.array([1.0, 0.0, 0.0])
        e1 = e1 - n * (e1 @ n)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(n, e1)
        return cls(texture=texture, p0=np.array([0.0, height, 0.0]), n=n, e1=e1, e2=e2, scale=scale)

    def render(self, K: np.ndarray, cam_to_world_R: np.ndarray, cam_pos: np.ndarray, H: int, W: int) -> np.ndarray:
        """Render the plane through an ideal pinhole camera: per-pixel
        ray/plane intersection + bilinear texture sampling, fully vectorized."""
        Kinv = np.linalg.inv(K)
        us, vs = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
        rays_cam = np.stack([us, vs, np.ones_like(us)], axis=-1) @ Kinv.T  # (H, W, 3)
        rays_w = rays_cam @ cam_to_world_R.T
        denom = rays_w @ self.n
        tnum = (self.p0 - cam_pos) @ self.n
        with np.errstate(divide="ignore", invalid="ignore"):
            tstar = tnum / denom
        hit = (tstar > 0.05) & np.isfinite(tstar)
        X = cam_pos + rays_w * tstar[..., None]
        rel = X - self.p0
        tex = self.texture
        th, tw = tex.shape
        u_t = (rel @ self.e1) / self.scale * tw + tw * 0.5
        v_t = (rel @ self.e2) / self.scale * th + th * 0.5
        u_t = np.clip(u_t, 0, tw - 1.001)
        v_t = np.clip(v_t, 0, th - 1.001)
        x0 = u_t.astype(np.int32)
        y0 = v_t.astype(np.int32)
        fx = u_t - x0
        fy = v_t - y0
        img = (
            tex[y0, x0] * (1 - fx) * (1 - fy)
            + tex[y0, x0 + 1] * fx * (1 - fy)
            + tex[y0 + 1, x0] * (1 - fx) * fy
            + tex[y0 + 1, x0 + 1] * fx * fy
        )
        return np.where(hit, img, 0.0).astype(np.float32)

    def depth(self, K: np.ndarray, cam_to_world_R: np.ndarray, cam_pos: np.ndarray, pixels: np.ndarray) -> np.ndarray:
        """Ground-truth z-depth (camera frame) of plane points behind pixels."""
        Kinv = np.linalg.inv(K)
        ph = np.concatenate([pixels, np.ones_like(pixels[..., :1])], axis=-1)
        rays_cam = ph @ Kinv.T
        rays_w = rays_cam @ cam_to_world_R.T
        tstar = ((self.p0 - cam_pos) @ self.n) / (rays_w @ self.n)
        return tstar * rays_cam[..., 2]


@dataclasses.dataclass
class StereoFrame:
    timestamp: float
    left: np.ndarray
    right: np.ndarray
    odom_translation: np.ndarray  # (3,)
    odom_rotation: np.ndarray  # (4,) [w,x,y,z]
    cam_to_world_R: np.ndarray
    cam_pos: np.ndarray


def generate_sequence(
    num_frames: int = 30,
    step: float = 0.25,
    yaw_rate: float = 0.01,
    rig: SyntheticRig | None = None,
    seed: int = 0,
    odom_drift: float = 0.0,
    texture_noise: float = 2.0,
    roll_rate: float = 0.0,
    pitch_rate: float = 0.0,
) -> Iterator[StereoFrame]:
    """A forward-moving, slowly-yawing stereo trajectory over the plane.

    Motion per frame (`step` metres) exceeds the reference's 0.2 m keyframe
    gate, so each frame becomes a keyframe. Odometry is the camera pose
    (robot frame == left camera frame in the synthetic rig); with
    `odom_drift > 0` the reported odometry accumulates a random-walk
    translation error of that magnitude (metres/frame) while the rendered
    images stay at ground truth — the realistic drifting-odometry scenario
    BA is supposed to correct (the reference README itself warns its
    odometry-derived trajectory drifts, reference: README.md:44).
    """
    rig = rig or SyntheticRig()
    tex = make_texture(seed, noise=texture_noise)
    scene = PlaneScene.ground(tex)
    K = rig.K()
    rng = np.random.default_rng(seed + 12345)
    pos = np.zeros(3)
    yaw = 0.0
    roll = 0.0
    pitch = 0.0
    drift = np.zeros(3)
    for i in range(num_frames):
        cy, sy = np.cos(yaw), np.sin(yaw)
        # Yaw about the camera's -y (up) axis.
        R = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
        q = np.array([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0])  # yaw about +y
        if roll_rate != 0.0 or pitch_rate != 0.0:
            # Full 3-DoF attitude: R = R_y(yaw) R_x(pitch) R_z(roll), with
            # the quaternion composed in the same order. Roll spins the
            # image in-plane (camera +z); pitch tilts the horizon (camera
            # +x; NEGATIVE pitch looks down in the y-down convention).
            cp, sp = np.cos(pitch), np.sin(pitch)
            cr, sr = np.cos(roll), np.sin(roll)
            Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float64)
            Rz = np.array([[cr, -sr, 0], [sr, cr, 0], [0, 0, 1]], np.float64)
            R = R @ Rx @ Rz
            qx = np.array([np.cos(pitch / 2), np.sin(pitch / 2), 0.0, 0.0])
            qz = np.array([np.cos(roll / 2), 0.0, 0.0, np.sin(roll / 2)])
            q = np_geom.quat_multiply(np_geom.quat_multiply(q, qx), qz)
        left = scene.render(K, R, pos, rig.height, rig.width)
        right_pos = pos + R @ np.array([rig.baseline, 0.0, 0.0])
        right = scene.render(K, R, right_pos, rig.height, rig.width)
        if odom_drift > 0 and i > 0:
            drift = drift + rng.normal(0.0, odom_drift, 3)
        yield StereoFrame(
            timestamp=float(i) * 0.5,
            left=left,
            right=right,
            odom_translation=pos + drift,
            odom_rotation=np_geom.quat_normalize(q),
            cam_to_world_R=R,
            cam_pos=pos.copy(),
        )
        pos = pos + R @ np.array([0.0, 0.0, step])
        yaw += yaw_rate
        roll += roll_rate
        pitch += pitch_rate
