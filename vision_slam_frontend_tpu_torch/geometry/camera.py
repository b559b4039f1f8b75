"""Pinhole + radial-tangential camera model, triangulation, epipolar geometry
(port of geometry/camera.py).

Intrinsics are plain Python floats, rounded to float32 as the reference
stores them. Point functions take tensors and compute in float32 (the
triangulation solve in float64);
`camera_matrix` and `fundamental_from_stereo` build the constant matrices in
numpy, once per configuration.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    """Pinhole intrinsics + radial (k1, k2, k3) / tangential (p1, p2)
    distortion, OpenCV convention."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    @classmethod
    def create(cls, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0) -> "Intrinsics":
        f32 = lambda v: float(np.float32(v))
        return cls(f32(fx), f32(fy), f32(cx), f32(cy), f32(k1), f32(k2), f32(p1), f32(p2), f32(k3))


def camera_matrix(intr: Intrinsics) -> np.ndarray:
    """3x3 K matrix, float32."""
    return np.array(
        [[intr.fx, 0.0, intr.cx], [0.0, intr.fy, intr.cy], [0.0, 0.0, 1.0]], np.float32
    )


def _div(a: torch.Tensor, scalar: float) -> torch.Tensor:
    # A tensor divisor keeps true division on the card: PyTorch's CUDA
    # division by a Python scalar multiplies by its reciprocal.
    return a / torch.full_like(a, scalar)


def undistort_points(intr: Intrinsics, pixels: torch.Tensor, num_iters: int = 8) -> torch.Tensor:
    """Observed pixel coords (..., 2) -> ideal pixel coords, by the
    fixed-point iteration x <- (x_d - tangential(x)) / radial(x) that
    cv::undistortPoints uses, re-projected through K."""
    xd = _div(pixels[..., 0] - intr.cx, intr.fx)
    yd = _div(pixels[..., 1] - intr.cy, intr.fy)
    x, y = xd, yd
    for _ in range(num_iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (intr.k1 + r2 * (intr.k2 + r2 * intr.k3))
        xy2 = 2.0 * x * y
        dx = intr.p1 * xy2 + intr.p2 * (r2 + 2.0 * x * x)
        dy = intr.p1 * (r2 + 2.0 * y * y) + intr.p2 * xy2
        x, y = (xd - dx) / radial, (yd - dy) / radial
    return torch.stack([x * intr.fx + intr.cx, y * intr.fy + intr.cy], dim=-1)


def _focal_centre(intr: Intrinsics, like: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(fx, fy) and (cx, cy) as float32 tensors on `like`'s device."""
    f = torch.tensor([intr.fx, intr.fy], dtype=torch.float32, device=like.device)
    c = torch.tensor([intr.cx, intr.cy], dtype=torch.float32, device=like.device)
    return f, c


def _distort_normalized(intr: Intrinsics, xn: torch.Tensor) -> torch.Tensor:
    """Radial + tangential distortion of normalized coords (..., 2)."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (intr.k1 + r2 * (intr.k2 + r2 * intr.k3))
    xy2 = 2.0 * x * y
    xd = x * radial + intr.p1 * xy2 + intr.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + intr.p1 * (r2 + 2.0 * y * y) + intr.p2 * xy2
    return torch.stack([xd, yd], dim=-1)


def distort_points(intr: Intrinsics, pixels_ideal: torch.Tensor) -> torch.Tensor:
    """Ideal (undistorted) pixel coords (..., 2) -> observed (distorted)."""
    f, c = _focal_centre(intr, pixels_ideal)
    return _distort_normalized(intr, (pixels_ideal - c) / f) * f + c


def project_points(intr: Intrinsics, points_cam: torch.Tensor, distort: bool = False) -> torch.Tensor:
    """Camera-frame 3D points (..., 3) -> pixel coords (..., 2). |z| below
    1e-9 is held at +-1e-9 (its sign kept); `distort` applies the lens
    model."""
    z = points_cam[..., 2:3]
    zsafe = torch.where(z.abs() < 1e-9, torch.where(z < 0, -1e-9, 1e-9), z)
    xn = points_cam[..., :2] / zsafe
    if distort:
        xn = _distort_normalized(intr, xn)
    f, c = _focal_centre(intr, points_cam)
    return xn * f + c


def _unit_rows(r: torch.Tensor) -> torch.Tensor:
    """Rows of a (..., 4) tensor scaled to unit length (norms below 1e-12
    clamp), the squares summed in a fixed order."""
    sq = r * r
    norm = (sq[..., 0] + sq[..., 1] + sq[..., 2] + sq[..., 3]).sqrt()
    return r / norm.clamp(min=1e-12)[..., None]


def triangulate_points(
    proj_left: torch.Tensor,
    proj_right: torch.Tensor,
    pixels_left: torch.Tensor,
    pixels_right: torch.Tensor,
) -> torch.Tensor:
    """Batched inhomogeneous DLT: (3, 4) projections and (N, 2) matched
    pixels -> (N, 3) left-camera points, in the pixels' dtype.

    Per match, rows [u P3 - P1; v P3 - P2] of each view, normalized; w = 1
    and the 4x3 least-squares system solved by its 3x3 normal equations in
    closed form (adjugate / determinant). The solve runs in float64: the
    normal equations square the system's condition number, and in float32
    (as the JAX package computes them) near-rectified stereo pairs lose up
    to ~4e-3 relative on the synthetic world. Every sum is written out in a
    fixed order (no einsum, no norm reduction), so the CPU and the card give
    the same bits: a distant point's system is so ill-conditioned that a
    last-bit difference in the normal equations moves it by metres, and the
    guided gate of the next keyframe reads it."""
    dtype = pixels_left.dtype
    proj_left, proj_right, pixels_left, pixels_right = (
        t.to(torch.float64) for t in (proj_left, proj_right, pixels_left, pixels_right)
    )

    def rows(P, px):
        u = px[..., 0:1]
        v = px[..., 1:2]
        r1 = u * P[2][None, :] - P[0][None, :]
        r2 = v * P[2][None, :] - P[1][None, :]
        return _unit_rows(r1), _unit_rows(r2)

    l1, l2 = rows(proj_left, pixels_left)
    r1, r2 = rows(proj_right, pixels_right)
    A = torch.stack([l1, l2, r1, r2], dim=-2)  # (N, 4, 4)
    B = A[..., :3]
    b = -A[..., 3]
    # M = B^T B and v = B^T b, summed over the 4 rows in order.
    prod_M = B[..., :, :, None] * B[..., :, None, :]  # (N, 4, 3, 3)
    prod_v = B * b[..., None]  # (N, 4, 3)
    M = prod_M[..., 0, :, :] + prod_M[..., 1, :, :] + prod_M[..., 2, :, :] + prod_M[..., 3, :, :]
    v = prod_v[..., 0, :] + prod_v[..., 1, :] + prod_v[..., 2, :] + prod_v[..., 3, :]

    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m11, m12, m22 = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m12
    c01 = m02 * m12 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c11 = m00 * m22 - m02 * m02
    c12 = m01 * m02 - m00 * m12
    c22 = m00 * m11 - m01 * m01
    det = m00 * c00 + m01 * c01 + m02 * c02
    det = torch.where(det.abs() < 1e-18, 1e-18, det)
    x = (c00 * v[..., 0] + c01 * v[..., 1] + c02 * v[..., 2]) / det
    y = (c01 * v[..., 0] + c11 * v[..., 1] + c12 * v[..., 2]) / det
    z = (c02 * v[..., 0] + c12 * v[..., 1] + c22 * v[..., 2]) / det
    return torch.stack([x, y, z], dim=-1).to(dtype)


def skew(v: np.ndarray) -> np.ndarray:
    """3-vector -> skew-symmetric cross-product matrix."""
    return np.array(
        [[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]], dtype=np.asarray(v).dtype
    )


def inv_camera_matrix(K: np.ndarray) -> np.ndarray:
    """Inverse of a zero-skew camera matrix in closed form, in K's dtype:
    [[1/fx, 0, -cx * (1/fx)], [0, 1/fy, -cy * (1/fy)], [0, 0, 1]]. In float32
    it rounds as the JAX package's `jnp.linalg.inv(K)` does on the CPU (the
    offset multiplies by the reciprocal), which `np.linalg.inv` does not."""
    one = np.ones((), K.dtype)
    ifx, ify = one / K[0, 0], one / K[1, 1]
    return np.array(
        [[ifx, 0.0, -(K[0, 2] * ifx)], [0.0, ify, -(K[1, 2] * ify)], [0.0, 0.0, 1.0]], K.dtype
    )


def fundamental_from_stereo(
    K_left: np.ndarray, K_right: np.ndarray, R: np.ndarray, t: np.ndarray
) -> np.ndarray:
    """F with x_left^T F x_right = 0, for x_right_cam = R X + t:
    F = (K_r^{-T} [t]x R K_l^{-1})^T, for zero-skew camera matrices."""
    E = skew(t) @ R
    F_rl = inv_camera_matrix(K_right).T @ E @ inv_camera_matrix(K_left)
    return F_rl.T


def epipolar_residual(
    F: torch.Tensor, pixels_left: torch.Tensor, pixels_right: torch.Tensor
) -> torch.Tensor:
    """|x_l^T F x_r| per match, (N,)."""
    ones = torch.ones_like(pixels_left[..., :1])
    xl = torch.cat([pixels_left, ones], dim=-1)
    xr = torch.cat([pixels_right, ones], dim=-1)
    return torch.einsum("ni,ij,nj->n", xl, F, xr).abs()
