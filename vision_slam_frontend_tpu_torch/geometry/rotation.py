"""Quaternion and rotation ops (port of geometry/rotation.py).

Quaternions are [w, x, y, z] (scalar first, Hamilton convention); a
quaternion q rotates a point from the local frame into the parent frame.
Every op broadcasts over leading batch dimensions and works under
`torch.func.vmap` / `jacfwd` (the BA residuals differentiate through them).
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def quat_identity(dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Identity quaternion [1, 0, 0, 0]."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize to a unit quaternion; guards the zero quaternion."""
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=_EPS)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b: rotation b followed by rotation a."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    """[w, -x, -y, -z]."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a (unit) quaternion: the conjugate after normalization."""
    return quat_conjugate(quat_normalize(q))


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vector(s) v by quaternion(s) q, in the expanded Rodrigues
    form v' = v + 2*w*(u x v) + 2*(u x (u x v))."""
    w = q[..., :1]
    u = q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion(s) (..., 4) -> rotation matrices (..., 3, 3)."""
    w, x, y, z = quat_normalize(q).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> unit quaternion [w, x, y, z], branch-free:
    all four of Shepperd's candidates, the one seeded by the largest of
    (trace, m00, m11, m22) selected, sign canonicalized to w >= 0."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    s0 = torch.sqrt((1.0 + tr).clamp(min=_EPS)) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = torch.sqrt((1.0 + m00 - m11 - m22).clamp(min=_EPS)) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = torch.sqrt((1.0 - m00 + m11 - m22).clamp(min=_EPS)) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = torch.sqrt((1.0 - m00 - m11 + m22).clamp(min=_EPS)) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)

    best = torch.stack([tr, m00, m11, m22], -1).argmax(-1)  # first maximum, as jnp.argmax
    cands = torch.stack([q0, q1, q2, q3], -2)  # (..., 4, 4)
    q = torch.take_along_dim(cands, best[..., None, None], dim=-2).squeeze(-2)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return quat_normalize(q)


def axis_angle_to_quat(aa: torch.Tensor) -> torch.Tensor:
    """Scaled axis-angle (so(3)) -> unit quaternion; small angles through
    the sinc expansion."""
    angle2 = torch.sum(aa * aa, dim=-1, keepdim=True)
    angle = torch.sqrt(angle2.clamp(min=_EPS))
    half = 0.5 * angle
    small = angle2 < 1e-8
    # sin(half)/angle, with the Taylor form 0.5 - angle^2/48 for tiny angles.
    k = torch.where(small, 0.5 - angle2 / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - angle2 / 8.0, torch.cos(half))
    return quat_normalize(torch.cat([w, aa * k], dim=-1))


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> scaled axis-angle; small angles handled."""
    q = quat_normalize(q)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)  # w >= 0: angle in [0, pi]
    w = q[..., :1].clamp(-1.0, 1.0)
    v = q[..., 1:]
    vnorm = torch.linalg.norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(vnorm, w)
    small = vnorm < 1e-8
    # angle/vnorm ~ 2/w for small angles.
    k = torch.where(small, 2.0 / w.clamp(min=_EPS), angle / vnorm.clamp(min=_EPS))
    return v * k


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    return quat_to_matrix(axis_angle_to_quat(aa))


def matrix_to_axis_angle(m: torch.Tensor) -> torch.Tensor:
    return quat_to_axis_angle(matrix_to_quat(m))


def quat_angular_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Angle (radians) of the relative rotation between two unit
    quaternions (Eigen's angularDistance, the keyframe gate's measure)."""
    d = torch.sum(quat_normalize(a) * quat_normalize(b), dim=-1).abs()
    return 2.0 * torch.arccos(d.clamp(0.0, 1.0))
