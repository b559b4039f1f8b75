"""Numpy quaternion helpers for the host loop (a copy of the JAX package's
utils/np_geom.py, so the port runs where the JAX package is not installed).

The per-frame odometry gate and pose composition are O(1) scalar math on the
host. Quaternions are [w, x, y, z].
"""

from __future__ import annotations

import numpy as np


def quat_normalize(q: np.ndarray) -> np.ndarray:
    return q / max(float(np.linalg.norm(q)), 1e-12)


def quat_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dtype=np.float64,
    )


def quat_inverse(q: np.ndarray) -> np.ndarray:
    return quat_normalize(np.array([q[0], -q[1], -q[2], -q[3]], dtype=np.float64))


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    w, u = q[0], np.asarray(q[1:], np.float64)
    v = np.asarray(v, np.float64)
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def quat_angular_distance(a: np.ndarray, b: np.ndarray) -> float:
    d = abs(float(np.dot(quat_normalize(a), quat_normalize(b))))
    return 2.0 * float(np.arccos(min(1.0, d)))


def axis_angle_to_quat(aa: np.ndarray) -> np.ndarray:
    aa = np.asarray(aa, np.float64)
    angle = float(np.linalg.norm(aa))
    if angle < 1e-12:
        return np.array([1.0, 0.0, 0.0, 0.0])
    axis = aa / angle
    return np.concatenate([[np.cos(angle / 2)], np.sin(angle / 2) * axis])


def axis_angle_to_matrix(aa: np.ndarray) -> np.ndarray:
    """Rodrigues' formula."""
    aa = np.asarray(aa, np.float64)
    angle = float(np.linalg.norm(aa))
    if angle < 1e-12:
        return np.eye(3)
    k = aa / angle
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * (K @ K)


def quat_multiply_batch(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Broadcasting Hamilton product over leading axes ((..., 4) x (..., 4))."""
    aw, ax, ay, az = np.moveaxis(np.asarray(a, np.float64), -1, 0)
    bw, bx, by, bz = np.moveaxis(np.asarray(b, np.float64), -1, 0)
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_to_axis_angle(q: np.ndarray) -> np.ndarray:
    q = quat_normalize(np.asarray(q, np.float64))
    if q[0] < 0:
        q = -q
    w = min(1.0, max(-1.0, q[0]))
    v = q[1:]
    vn = float(np.linalg.norm(v))
    if vn < 1e-12:
        return np.zeros(3)
    angle = 2.0 * float(np.arctan2(vn, w))
    return v * (angle / vn)
