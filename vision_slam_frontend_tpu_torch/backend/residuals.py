"""BA residuals and per-factor Jacobians (port of backend/residuals.py).

Reprojection: world landmark -> robot frame (pose^{-1}) -> camera frame
(extrinsic^{-1}) -> pinhole projection with the left camera's K; residual
against the node's undistorted pixel observation. Stereo adds the right
camera through the rig's right extrinsic.

Odometry: 6-vector residual of the measured relative pose against the
current estimates, [translation error in frame i; so(3) log of the rotation
error], per-component weighted.

Local parameterization: pose delta d = [dt (world); dtheta (right-multiplied
so(3), the retraction `_apply_pose_delta`)], landmark delta Euclidean.
The JAX package takes the Jacobians at d = 0 with `jax.jacfwd` under
`jax.vmap`; here they are the same derivatives in closed form, batched over
the factors: the chain rule through the same quaternion formulas, a few
dozen elementwise ops, where forward-mode autodiff through `torch.func`
runs Python-level decompositions for most ops on every call.
tests/test_torch_backend.py holds them to the JAX package's Jacobians.

Small products (3x3 by 3-vector) are written as elementwise sums, not
matmuls, so no setting of TF32 can reach them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from vision_slam_frontend_tpu_torch.geometry.rotation import (
    axis_angle_to_quat,
    quat_inverse,
    quat_multiply,
    quat_rotate,
    quat_to_axis_angle,
)
from vision_slam_frontend_tpu_torch.utils.device import resolve_device


_EPS = 1e-12


def _f32(x, device=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32, device=device)
    return torch.tensor(np.asarray(x, np.float32), device=device)


@dataclasses.dataclass
class CameraParams:
    """Stereo projection used by the solver: the left camera, and the right
    camera through the rig's right-extrinsic block (x_right = R_rl x_left +
    t_rl). Every field is a float32 tensor on one device."""

    fx: Any
    fy: Any
    cx: Any
    cy: Any
    # camera -> robot extrinsic
    R_cr: Any  # (3, 3)
    t_cr: Any  # (3,)
    # right camera (stereo constraint); defaults mirror the left camera with
    # an identity extrinsic (observations then need obs_right_mask=False).
    fx_r: Any = None
    fy_r: Any = None
    cx_r: Any = None
    cy_r: Any = None
    R_rl: Any = None  # (3, 3)
    t_rl: Any = None  # (3,)

    def __post_init__(self):
        if self.fx_r is None:
            self.fx_r, self.fy_r, self.cx_r, self.cy_r = self.fx, self.fy, self.cx, self.cy
        if self.R_rl is None:
            self.R_rl, self.t_rl = torch.eye(3), torch.zeros(3)
        device = self.fx.device if isinstance(self.fx, torch.Tensor) else None
        for f in dataclasses.fields(self):
            setattr(self, f.name, _f32(getattr(self, f.name), device))

    @classmethod
    def from_config(cls, config, device="cuda") -> "CameraParams":
        """The camera of a FrontendConfig on `device` (the GPU unless the
        caller names the CPU)."""
        device = resolve_device(device)
        intr = config.intrinsics_left
        intr_r = config.intrinsics_right
        ext = _f32(config.left_cam_to_robot)
        A_r = _f32(config.calib["right_extrinsic"])
        return cls(
            fx=intr.fx, fy=intr.fy, cx=intr.cx, cy=intr.cy,
            R_cr=ext[:3, :3], t_cr=ext[:3, 3],
            fx_r=intr_r.fx, fy_r=intr_r.fy, cx_r=intr_r.cx, cy_r=intr_r.cy,
            R_rl=A_r[:, :3], t_rl=A_r[:, 3],
        ).to(device)

    def to(self, device) -> "CameraParams":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
        })


def _mv(R, v):
    """R @ v for a (3, 3) R and (..., 3) v."""
    return (R * v[..., None, :]).sum(-1)


def _mtv(R, v):
    """R^T @ v for a (3, 3) R and (..., 3) v."""
    return (R * v[..., :, None]).sum(-2)


def _apply_pose_delta(t, q, d):
    """Retraction: t += dt, q <- q * exp(dtheta)."""
    return t + d[..., :3], quat_multiply(q, axis_angle_to_quat(d[..., 3:]))


def _pinhole(p, fx, fy, cx, cy, px):
    """Pinhole residual; points behind the camera get a large (but finite,
    differentiable) residual so the solver pushes them back."""
    z = p[..., 2]
    zsafe = torch.where(z.abs() < 1e-6, torch.where(z < 0, -1e-6, 1e-6), z)
    pred = torch.stack([fx * p[..., 0] / zsafe + cx, fy * p[..., 1] / zsafe + cy], -1)
    r = pred - px
    return torch.where((z > 1e-6)[..., None], r, r.clamp(-1e4, 1e4))


def reproject_residual(cam: CameraParams, t, q, landmark, pixel):
    """Single-observation residual (2,), given pose (t, q) and world landmark."""
    p_robot = quat_rotate(quat_inverse(q), landmark - t)
    p_cam = _mtv(cam.R_cr, p_robot - cam.t_cr)
    return _pinhole(p_cam, cam.fx, cam.fy, cam.cx, cam.cy, pixel)


def reproject_residual_stereo(cam: CameraParams, t, q, landmark, pixel_l, pixel_r, has_right):
    """Stereo residual (4,): [left u, v; right u, v]; the right rows are
    zeroed where the observation has no stereo match (has_right = 0)."""
    p_robot = quat_rotate(quat_inverse(q), landmark - t)
    p_l = _mtv(cam.R_cr, p_robot - cam.t_cr)
    r_l = _pinhole(p_l, cam.fx, cam.fy, cam.cx, cam.cy, pixel_l)
    p_r = _mv(cam.R_rl, p_l) + cam.t_rl
    r_r = _pinhole(p_r, cam.fx_r, cam.fy_r, cam.cx_r, cam.cy_r, pixel_r) * has_right[..., None]
    return torch.cat([r_l, r_r], -1)


def _basis(like) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _skew(v):
    """(..., 3) -> (..., 3, 3) with _skew(v) @ w = v x w."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack(
        [torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)], -2,
    )


def _rot_columns(q):
    """(..., 4) -> (..., 3, 3) whose column k is quat_rotate(q, e_k)."""
    return quat_rotate(q[..., None, :], _basis(q)).transpose(-1, -2)


def _mm(A, B):
    """A @ B for a (3, 3) A and (..., 3, k) B."""
    return (A[:, :, None] * B[..., None, :, :]).sum(-2)


def _pinhole_lin(p, dp, fx, fy, cx, cy, px):
    """`_pinhole` (..., 2) and its derivative (..., 2, k) along dp (..., 3, k)."""
    x, y, z = p.unbind(-1)
    near = z.abs() < 1e-6  # zsafe is a constant there
    zs = torch.where(near, torch.where(z < 0, -1e-6, 1e-6), z)
    r = torch.stack([fx * x / zs + cx, fy * y / zs + cy], -1) - px
    du = (fx / zs)[..., None] * dp[..., 0, :] - torch.where(near, 0.0, fx * x / (zs * zs))[..., None] * dp[..., 2, :]
    dv = (fy / zs)[..., None] * dp[..., 1, :] - torch.where(near, 0.0, fy * y / (zs * zs))[..., None] * dp[..., 2, :]
    front = (z > 1e-6)[..., None]
    keep = front | ((r > -1e4) & (r < 1e4))  # the clip passes derivatives inside its range
    return torch.where(front, r, r.clamp(-1e4, 1e4)), torch.stack([du, dv], -2) * keep[..., None]


def _reproj_lin(cam, t, q, landmark, pixel, pixel_r=None, has_right=None):
    """Residuals r (N, D) and Jacobians J_pose (N, D, 6), J_lm (N, D, 3) at
    zero deltas: p_robot = R^T (X - t) moves by -R^T dt, by [p_robot]x dtheta
    (the retraction q * exp(dtheta)) and by R^T dX."""
    q_inv = quat_inverse(q)
    p_robot = quat_rotate(q_inv, landmark - t)
    Rt = _rot_columns(q_inv).expand(p_robot.shape + (3,))
    dp = torch.cat([-Rt, _skew(p_robot), Rt], -1)  # (N, 3, 9): [dt, dtheta, dX]
    p_l = _mtv(cam.R_cr, p_robot - cam.t_cr)
    dp_l = _mm(cam.R_cr.T, dp)
    r, J = _pinhole_lin(p_l, dp_l, cam.fx, cam.fy, cam.cx, cam.cy, pixel)
    if pixel_r is not None:
        h = has_right[..., None]
        r_r, J_r = _pinhole_lin(_mv(cam.R_rl, p_l) + cam.t_rl, _mm(cam.R_rl, dp_l),
                                cam.fx_r, cam.fy_r, cam.cx_r, cam.cy_r, pixel_r)
        r = torch.cat([r, r_r * h], -1)
        J = torch.cat([J, J_r * h[..., None]], -2)
    return r, J[..., :6], J[..., 6:]


def _mask_terms(r, Jp, Jl, mask):
    m = mask[..., None].to(r.dtype)
    return r * m, Jp * m[..., None], Jl * m[..., None]


def _stereo_inputs(obs_pixel_right, obs_right_mask, dtype):
    return (None, None) if obs_pixel_right is None else (obs_pixel_right, obs_right_mask.to(dtype))


def reprojection_residuals(
    cam: CameraParams, poses_t, poses_q, landmarks, obs_pose, obs_landmark,
    obs_pixel, obs_mask, obs_pixel_right=None, obs_right_mask=None,
):
    """The residuals r (N, D) of `linearize_reprojection` alone (what the
    cost and the trim rounds read)."""
    t, q, lm = poses_t[obs_pose], poses_q[obs_pose], landmarks[obs_landmark]
    if obs_pixel_right is None:
        r = reproject_residual(cam, t, q, lm, obs_pixel)
    else:
        has_r = obs_right_mask.to(poses_t.dtype)
        r = reproject_residual_stereo(cam, t, q, lm, obs_pixel, obs_pixel_right, has_r)
    return r * obs_mask[:, None].to(r.dtype)


def linearize_reprojection(
    cam: CameraParams, poses_t, poses_q, landmarks, obs_pose, obs_landmark,
    obs_pixel, obs_mask, obs_pixel_right=None, obs_right_mask=None,
):
    """Batched residuals + Jacobians for all observations.

    Returns r (N, D), J_pose (N, D, 6), J_lm (N, D, 3) with D=4 when stereo
    pixels are provided (rows 2:4 zeroed for mono observations), D=2
    otherwise; everything zeroed for invalid observations.
    """
    pxr, has_r = _stereo_inputs(obs_pixel_right, obs_right_mask, poses_t.dtype)
    terms = _reproj_lin(cam, poses_t[obs_pose], poses_q[obs_pose], landmarks[obs_landmark], obs_pixel, pxr, has_r)
    return _mask_terms(*terms, obs_mask)


def linearize_reprojection_pm(
    cam: CameraParams, poses_t, poses_q, landmarks, pm_landmark,
    pm_pixel, pm_mask, pm_pixel_right=None, pm_right_mask=None,
):
    """Pose-major linearization: residuals + Jacobians emitted directly in
    (P, Mp, ...) layout. Row p of every pm_* input holds pose p's
    observations (backend/tracks.build_gather_tables), so the pose
    parameters broadcast per row and only the landmark positions are
    gathered.

    Returns r (P, Mp, D), J_pose (P, Mp, D, 6), J_lm (P, Mp, D, 3), all
    zeroed on masked slots. D = 4 with stereo pixels, else 2.
    """
    pxr, has_r = _stereo_inputs(pm_pixel_right, pm_right_mask, poses_t.dtype)
    terms = _reproj_lin(cam, poses_t[:, None], poses_q[:, None], landmarks[pm_landmark], pm_pixel, pxr, has_r)
    return _mask_terms(*terms, pm_mask)


def odometry_residual(t_i, q_i, t_j, q_j, t_meas, q_meas, w_t, w_r):
    """6-vector weighted relative-pose residual."""
    qi_inv = quat_inverse(q_i)
    t_rel = quat_rotate(qi_inv, t_j - t_i)
    q_rel = quat_multiply(qi_inv, q_j)
    r_t = (t_rel - t_meas) * w_t
    r_r = quat_to_axis_angle(quat_multiply(quat_inverse(q_meas), q_rel)) * w_r
    return torch.cat([r_t, r_r], -1)


def _axis_angle_lin(E, dE):
    """quat_to_axis_angle(E) (..., 3) and its derivative (..., 3, k) along
    dE (..., k, 4), step by step through the same formula (normalize, sign,
    clip, the small-angle branch)."""
    nrm = torch.linalg.norm(E, dim=-1, keepdim=True).clamp(min=_EPS)
    n = E / nrm
    dn = (dE - n[..., None, :] * (dE * n[..., None, :]).sum(-1, keepdim=True)) / nrm[..., None, :]
    sign = torch.where(n[..., :1] < 0, -1.0, 1.0)
    n, dn = n * sign, dn * sign[..., None, :]
    w_raw = n[..., :1]
    w = w_raw.clamp(-1.0, 1.0)
    # The clip's derivative: 1 inside, 1/2 on a bound (a tie of min/max), 0 outside.
    dw = dn[..., :1] * torch.where(w_raw.abs() < 1.0, 1.0, torch.where(w_raw.abs() == 1.0, 0.5, 0.0))[..., None, :]
    v, dv = n[..., 1:], dn[..., 1:]
    vnorm = torch.linalg.norm(v, dim=-1, keepdim=True)
    vn = vnorm.clamp(min=_EPS)
    dvnorm = (dv * v[..., None, :]).sum(-1, keepdim=True) / vn[..., None, :]
    angle = 2.0 * torch.atan2(vnorm, w)
    dangle = 2.0 * (w[..., None, :] * dvnorm - vnorm[..., None, :] * dw) / (w * w + vnorm * vnorm)[..., None, :]
    small = vnorm < 1e-8
    wc = w.clamp(min=_EPS)
    k = torch.where(small, 2.0 / wc, angle / vn)
    dk_small = -2.0 * dw / (wc * wc)[..., None, :]
    dk_big = dangle / vn[..., None, :] - (angle / (vn * vn))[..., None, :] * dvnorm
    dk = torch.where(small[..., None, :], dk_small, dk_big)
    dr = dv * k[..., None, :] + v[..., None, :] * dk
    return v * k, dr.transpose(-1, -2)


def _odom_lin(t_i, q_i, t_j, q_j, t_meas, q_meas, w_t, w_r):
    """odometry_residual (Q, 6) and its Jacobians J_i, J_j (Q, 6, 6) at zero
    deltas. Translation rows: t_rel = R_i^T (t_j - t_i) moves by -R_i^T
    dt_i, [t_rel]x dtheta_i and R_i^T dt_j. Rotation rows: the error
    E = q_meas^-1 q_i^-1 q_j moves by q_meas^-1 (-1/2 dtheta_i) q_i^-1 q_j
    and E (1/2 dtheta_j) (pure quaternions), through the axis-angle map."""
    qi_inv = quat_inverse(q_i)
    t_rel = quat_rotate(qi_inv, t_j - t_i)
    q_rel = quat_multiply(qi_inv, q_j)
    qm_inv = quat_inverse(q_meas)
    E = quat_multiply(qm_inv, q_rel)
    half = torch.cat([torch.zeros_like(t_rel[:1, :1]).expand(3, 1), 0.5 * _basis(t_rel)], -1)  # (3, 4)
    dE_i = quat_multiply(quat_multiply(qm_inv[..., None, :], -half), q_rel[..., None, :])
    dE_j = quat_multiply(E[..., None, :], half)
    rot, drot = _axis_angle_lin(E, torch.cat([dE_i, dE_j], -2))
    Rt = _rot_columns(qi_inv)
    zero = torch.zeros_like(Rt)
    J_i = torch.cat([torch.cat([-Rt, _skew(t_rel)], -1) * w_t, torch.cat([zero, drot[..., :3]], -1) * w_r], -2)
    J_j = torch.cat([torch.cat([Rt, zero], -1) * w_t, torch.cat([zero, drot[..., 3:]], -1) * w_r], -2)
    return torch.cat([(t_rel - t_meas) * w_t, rot * w_r], -1), J_i, J_j


def odometry_residuals(poses_t, poses_q, odom_i, odom_j, odom_t, odom_q, odom_mask, w_t, w_r):
    """The residuals r (Q, 6) of `linearize_odometry` alone."""
    r = odometry_residual(poses_t[odom_i], poses_q[odom_i], poses_t[odom_j], poses_q[odom_j],
                          odom_t, odom_q, w_t, w_r)
    return r * odom_mask[:, None].to(r.dtype)


def linearize_odometry(poses_t, poses_q, odom_i, odom_j, odom_t, odom_q, odom_mask, w_t, w_r):
    """Batched odometry residuals + Jacobians: r (Q, 6), J_i/J_j (Q, 6, 6)."""
    terms = _odom_lin(poses_t[odom_i], poses_q[odom_i], poses_t[odom_j], poses_q[odom_j],
                      odom_t, odom_q, w_t, w_r)
    return _mask_terms(*terms, odom_mask)


def huber_weights(r: torch.Tensor, delta) -> torch.Tensor:
    """Per-residual-row sqrt IRLS weights for the Huber loss. r is (..., D);
    the weight is per row; delta None gives ones."""
    if delta is None:
        return torch.ones(r.shape[:-1], dtype=r.dtype, device=r.device)
    norm = torch.linalg.norm(r, dim=-1)
    return torch.where(norm <= delta, 1.0, torch.sqrt(delta / norm.clamp(min=1e-12)))
