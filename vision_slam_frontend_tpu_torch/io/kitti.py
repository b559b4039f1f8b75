"""KITTI odometry dataset loader, stereo grayscale sequences (port of io/kitti.py).

Layout (standard KITTI odometry benchmark):
  <seq_dir>/image_0/NNNNNN.png   left grayscale
  <seq_dir>/image_1/NNNNNN.png   right grayscale
  <seq_dir>/calib.txt            P0..P3 rectified projection rows
  <seq_dir>/times.txt            per-frame timestamps (seconds)
  poses file: <seq_dir>/poses.txt, <root>/poses/<seq>.txt, or
  <seq_dir>.txt next to a sequences/ tree — 3x4 cam0-to-world per line,
  used as the odometry stream (KITTI has no separate odometry; the
  ground-truth trajectory plays that role, as is standard for frontend
  evaluation).

KITTI images are rectified: zero distortion, right camera a pure x-baseline
(P1[0,3] = -fx * baseline).
"""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np

from vision_slam_frontend_tpu_torch.io.image import load_gray, write_gray
from vision_slam_frontend_tpu_torch.utils import np_geom


def _resolve_seq_dir(path: str, sequence: Optional[str]) -> str:
    if sequence is None:
        return path
    for cand in (
        os.path.join(path, "sequences", sequence),
        os.path.join(path, sequence),
    ):
        if os.path.isdir(cand):
            return cand
    raise FileNotFoundError(f"KITTI sequence {sequence!r} not found under {path}")


def _read_calib(seq_dir: str) -> dict:
    calib_path = os.path.join(seq_dir, "calib.txt")
    mats = {}
    with open(calib_path) as f:
        for line in f:
            if ":" not in line:
                continue
            name, vals = line.split(":", 1)
            arr = np.array([float(v) for v in vals.split()], np.float64)
            if arr.size == 12:
                mats[name.strip()] = arr.reshape(3, 4)
    return mats


def kitti_calib(path: str, sequence: Optional[str] = None) -> dict:
    """FrontendConfig-compatible calib dict from a KITTI calib.txt."""
    seq_dir = _resolve_seq_dir(path, sequence)
    mats = _read_calib(seq_dir)
    P0, P1 = mats["P0"], mats["P1"]
    fx, fy, cx, cy = P0[0, 0], P0[1, 1], P0[0, 2], P0[1, 2]
    baseline = -P1[0, 3] / P1[0, 0]
    zero = dict(k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0)
    return {
        "intrinsics_left": dict(fx=fx, fy=fy, cx=cx, cy=cy, **zero),
        "intrinsics_right": dict(
            fx=P1[0, 0], fy=P1[1, 1], cx=P1[0, 2], cy=P1[1, 2], **zero
        ),
        "right_extrinsic": [
            [1.0, 0.0, 0.0, -baseline],
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


def _find_poses(path: str, seq_dir: str, sequence: Optional[str]) -> Optional[str]:
    cands = [os.path.join(seq_dir, "poses.txt")]
    if sequence is not None:
        cands.append(os.path.join(path, "poses", f"{sequence}.txt"))
    for c in cands:
        if os.path.isfile(c):
            return c
    return None


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 -> [w,x,y,z] via the robust Shepperd construction (numpy)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s]
        )
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        q = np.array(
            [(R[2, 1] - R[1, 2]) / s, 0.25 * s, (R[0, 1] + R[1, 0]) / s, (R[0, 2] + R[2, 0]) / s]
        )
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        q = np.array(
            [(R[0, 2] - R[2, 0]) / s, (R[0, 1] + R[1, 0]) / s, 0.25 * s, (R[1, 2] + R[2, 1]) / s]
        )
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        q = np.array(
            [(R[1, 0] - R[0, 1]) / s, (R[0, 2] + R[2, 0]) / s, (R[1, 2] + R[2, 1]) / s, 0.25 * s]
        )
    return np_geom.quat_normalize(q)


def iter_kitti_events(path: str, sequence: Optional[str] = None) -> Iterator[tuple]:
    """Yield ("odometry"/"stereo", t, payload) events, time-ordered."""
    seq_dir = _resolve_seq_dir(path, sequence)
    left_dir = os.path.join(seq_dir, "image_0")
    right_dir = os.path.join(seq_dir, "image_1")
    frames = sorted(f for f in os.listdir(left_dir) if f.endswith(".png"))
    times_path = os.path.join(seq_dir, "times.txt")
    if os.path.isfile(times_path):
        times = np.loadtxt(times_path).reshape(-1)
    else:
        times = np.arange(len(frames), dtype=np.float64) * 0.1
    poses_path = _find_poses(path, seq_dir, sequence)
    if poses_path is None:
        raise FileNotFoundError(
            f"No poses file for {seq_dir} (need poses.txt or poses/<seq>.txt to "
            "drive the odometry-gated frontend)"
        )
    poses = np.loadtxt(poses_path).reshape(-1, 3, 4)
    n = min(len(frames), len(times), len(poses))
    for i in range(n):
        R = poses[i, :, :3]
        t = poses[i, :, 3]
        yield ("odometry", float(times[i]), (t, rotmat_to_quat(R)))
        left = load_gray(os.path.join(left_dir, frames[i]))
        right = load_gray(os.path.join(right_dir, frames[i]))
        yield ("stereo", float(times[i]), (left, right))


def write_sequence(seq_dir: str, frames, rig) -> None:
    """A KITTI sequence of rendered stereo frames (io/synthetic.py):
    image_0/1 PNGs, times.txt, poses.txt (camera-to-world, the odometry
    stream) and calib.txt for `rig`. For tests and the GPU smoke test."""
    os.makedirs(os.path.join(seq_dir, "image_0"))
    os.makedirs(os.path.join(seq_dir, "image_1"))
    times, poses = [], []
    for i, f in enumerate(frames):
        write_gray(os.path.join(seq_dir, "image_0", f"{i:06d}.png"), f.left)
        write_gray(os.path.join(seq_dir, "image_1", f"{i:06d}.png"), f.right)
        times.append(f.timestamp)
        poses.append(np.hstack([f.cam_to_world_R, f.cam_pos[:, None]]).ravel())
    np.savetxt(os.path.join(seq_dir, "times.txt"), np.array(times))
    np.savetxt(os.path.join(seq_dir, "poses.txt"), np.array(poses))
    P0 = np.hstack([rig.K(), np.zeros((3, 1))])
    P1 = P0.copy()
    P1[0, 3] = -rig.fx * rig.baseline
    with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
        f.write("P0: " + " ".join(str(v) for v in P0.ravel()) + "\n")
        f.write("P1: " + " ".join(str(v) for v in P1.ravel()) + "\n")
