"""The benchmark's scene: a closed loop through a textured world, rendered
on the device from the seed.

The world (y down, as the camera's y): a ground plane `camera_height_m`
below the path, an outer cylindrical wall and, where it fits, an inner
pillar, both centred on the loop's centre and as tall as any ray needs, so
every image row carries texture. Each surface carries block value noise at
a few scales (cell sizes in metres), hashed from the seed with integer
arithmetic, so the same seed gives the same texture on any device. Pixels
are drawn through the configuration's published distortion (each output
pixel is undistorted to its ray, as cv::undistortPoints inverts the model),
2x2 supersampled and rounded to uint8.

The trajectory is a circle: the camera heads along the tangent and turns by
2 pi over `loop_frames` frames of `step_m` metres, so replaying the loop
cyclically is continuous. `loop_pose(phase)` gives the left camera's pose
for any phase, so odometry can be sampled at its own rate.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK62 = (1 << 62) - 1


def loop_radius(traffic: dict) -> float:
    return traffic["step_m"] * traffic["loop_frames"] / (2.0 * math.pi)


def loop_pose(traffic: dict, phase: float) -> np.ndarray:
    """4x4 float64 world-from-left-camera pose at loop phase `phase`
    (radians; one lap is 2 pi)."""
    r = loop_radius(traffic)
    c, s = math.cos(phase), math.sin(phase)
    T = np.eye(4)
    T[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    T[:3, 3] = [r * (1.0 - c), 0.0, r * s]
    return T


def matrix_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion [w, x, y, z], w >= 0."""
    m = np.asarray(R, np.float64)
    tr = m[0, 0] + m[1, 1] + m[2, 2]
    if tr > 0:
        s = math.sqrt(tr + 1.0) * 2.0
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2.0
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
    elif m[1, 1] > m[2, 2]:
        s = math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2.0
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s]
    else:
        s = math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2.0
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    q = np.asarray(q, np.float64)
    q /= np.linalg.norm(q)
    return -q if q[0] < 0 else q


def body_pose(traffic: dict, camera: dict, phase: float) -> tuple[np.ndarray, np.ndarray]:
    """(translation (3,), quaternion [w, x, y, z]) of the body at `phase`:
    world-from-camera composed with camera-from-body."""
    T_wc = loop_pose(traffic, phase)
    T_bc = np.asarray(camera["body_from_left_camera"], np.float64)
    T_wb = T_wc @ np.linalg.inv(T_bc)
    return T_wb[:3, 3].copy(), matrix_to_quat(T_wb[:3, :3])


def _mix(h: torch.Tensor) -> torch.Tensor:
    """A 62-bit integer hash step (xorshift-multiply), exact on any device."""
    h = h & _MASK62
    h = (h ^ (h >> 29)) * 0x2545F4914F6CDD1D & _MASK62
    h = (h ^ (h >> 32)) * 0x1B873593 & _MASK62
    return h ^ (h >> 27)


def _block_noise(u: torch.Tensor, v: torch.Tensor, cell: float, salt: int) -> torch.Tensor:
    """Uniform [0, 1) value per (cell x cell) block at surface coordinates
    (u, v) in metres."""
    iu = torch.floor(u / cell).to(torch.int64)
    iv = torch.floor(v / cell).to(torch.int64)
    h = _mix(iu * 0x9E3779B1 + _mix(iv * 0x85EBCA77 + salt))
    return (h & 0xFFFFFF).to(torch.float64) / float(1 << 24)


def _surface_value(u, v, layers, salt: int) -> torch.Tensor:
    acc = torch.zeros_like(u)
    for k, (cell, weight) in enumerate(layers):
        acc = acc + weight * (2.0 * _block_noise(u, v, cell, salt + 7919 * (k + 1)) - 1.0)
    return acc


def _undistort(intr: dict, u: torch.Tensor, v: torch.Tensor, iters: int = 30):
    """Distorted pixels -> normalized ideal coordinates (float64)."""
    xd = (u - intr["cx"]) / intr["fx"]
    yd = (v - intr["cy"]) / intr["fy"]
    x, y = xd, yd
    k1, k2, k3, p1, p2 = intr["k1"], intr["k2"], intr["k3"], intr["p1"], intr["p2"]
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = (xd - dx) / radial, (yd - dy) / radial
    return x, y


class Renderer:
    """Renders stereo frames of one configuration's rig in one traffic's
    world on `device`."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.cam = config["camera"]
        self.world = traffic["world"]
        self.traffic = traffic
        self.device = torch.device(device)
        self.salt = int(seed) & _MASK62
        H, W = self.cam["height"], self.cam["width"]
        sub = torch.tensor([0.25, 0.75], dtype=torch.float64, device=self.device)
        vs = torch.arange(H, dtype=torch.float64, device=self.device)[:, None, None, None] + sub[None, None, :, None]
        us = torch.arange(W, dtype=torch.float64, device=self.device)[None, :, None, None] + sub[None, None, None, :]
        vs, us = torch.broadcast_tensors(vs, us)  # (H, W, 2, 2) supersamples
        self.rays = {}
        for side in ("left", "right"):
            x, y = _undistort(self.cam[side], us - 0.5, vs - 0.5)
            self.rays[side] = torch.stack([x, y, torch.ones_like(x)], -1)  # camera-frame directions

    def _render(self, side: str, T_wc: np.ndarray) -> torch.Tensor:
        """(B, H, W) uint8 images of the camera poses T_wc (B, 4, 4)."""
        dev = self.device
        R = torch.as_tensor(T_wc[:, :3, :3], dtype=torch.float64, device=dev)
        o = torch.as_tensor(T_wc[:, :3, 3], dtype=torch.float64, device=dev)[:, None, None, None, None, :]
        d = torch.einsum("hwijk,bmk->bhwijm", self.rays[side], R)  # (B, H, W, 2, 2, 3) world directions
        w = self.world
        inf = torch.full(d.shape[:-1], float("inf"), dtype=torch.float64, device=dev)
        # Ground plane y = camera_height_m.
        t_g = torch.where(d[..., 1] > 1e-9, (w["camera_height_m"] - o[..., 1]) / d[..., 1].clamp(min=1e-9), inf)
        # Cylinders about the loop centre (cx, cz).
        cx, cz = loop_radius(self.traffic), 0.0
        ox, oz = o[..., 0] - cx, o[..., 2] - cz
        a = d[..., 0] ** 2 + d[..., 2] ** 2
        b = 2.0 * (ox * d[..., 0] + oz * d[..., 2])
        a_safe = a.clamp(min=1e-12)
        r_out = cx + w["outer_wall_m"]
        disc_o = (b * b - 4.0 * a * (ox * ox + oz * oz - r_out * r_out)).clamp(min=0.0)
        t_o = (-b + torch.sqrt(disc_o)) / (2.0 * a_safe)
        r_in = cx - w["inner_wall_m"]
        if r_in > 0.2:
            disc_i = b * b - 4.0 * a * (ox * ox + oz * oz - r_in * r_in)
            t_i = (-b - torch.sqrt(disc_i.clamp(min=0.0))) / (2.0 * a_safe)
            t_i = torch.where((disc_i > 0) & (t_i > 1e-6), t_i, inf)
        else:
            t_i = inf
        t_w = torch.minimum(t_o, t_i)
        hit_ground = t_g < t_w
        t = torch.where(hit_ground, t_g, t_w)
        X = o + d * t[..., None]
        ang = torch.atan2(X[..., 2] - cz, X[..., 0] - cx)
        inner = t_i < t_o
        radius = torch.where(inner, r_in, r_out)
        v_ground = _surface_value(X[..., 0], X[..., 2], w["ground_layers"], self.salt)
        v_wall = _surface_value(ang * radius, X[..., 1], w["wall_layers"],
                                self.salt + torch.where(inner, 1, 2).to(torch.int64))
        val = torch.where(hit_ground, v_ground, v_wall)
        img = (w["mean"] + w["contrast"] * val).clamp(0.0, 255.0).mean(dim=(-1, -2))
        return torch.round(img).to(torch.uint8)

    def frames(self, phases) -> tuple[torch.Tensor, torch.Tensor]:
        """(left, right) (B, H, W) uint8 on the device at loop `phases`."""
        T_wl = np.stack([loop_pose(self.traffic, p) for p in phases])
        T_lr = np.eye(4)
        T_lr[0, 3] = self.cam["baseline_m"]  # the right camera at +baseline along the left's x
        return self._render("left", T_wl), self._render("right", T_wl @ T_lr)

    def loop_frames(self, batch: int = 8) -> list[tuple[np.ndarray, np.ndarray]]:
        """Every frame of the loop as host (left, right) uint8 arrays."""
        n = self.traffic["loop_frames"]
        out = []
        for b0 in range(0, n, batch):
            left, right = self.frames([2.0 * math.pi * i / n for i in range(b0, min(b0 + batch, n))])
            left, right = left.cpu().numpy(), right.cpu().numpy()
            out += list(zip(left, right))
        return out
