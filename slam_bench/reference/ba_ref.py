"""Plain reference of offline bundle adjustment: Levenberg-Marquardt on the
stereo reprojection and odometry factors, every product in float64.

It follows the schedule the port documents for BASolverConfig's defaults:
Huber 4 px as IRLS row weights, odometry weights 30 and 60, pose 0 fixed,
lambda from 1e-3 (x 0.4 on an accepted step, x 4 on a refused one, x 64 on
a non-finite one), landmark damping floored at 1e-5 of its block's trace,
the reduced camera system equilibrated by its diagonal with a 1e-3 ridge,
at most 15 iterations, stopping on a relative decrease under 1e-6, lambda
at 1e6 or four refusals after an acceptance. Jacobians are taken at
the retraction t + dt, q * exp(dtheta): in closed form for the
reprojections, by central differences in float64 for the odometry factors.
Plain PyTorch; nothing of the program.

`dtype=torch.bfloat16` is the control: residuals, Jacobians and costs in
bfloat16, sums and the solve in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def q_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw], -1)


def q_norm(q):
    return q / torch.sqrt((q * q).sum(-1, keepdim=True)).clamp(min=1e-12)


def q_inv(q):
    q = q_norm(q)
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def q_rot(q, v):
    w, u = q[..., :1], q[..., 1:]
    u, v = torch.broadcast_tensors(u, v)
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def q_exp(aa):
    a2 = (aa * aa).sum(-1, keepdim=True)
    a = torch.sqrt(a2.clamp(min=1e-12))
    small = a2 < 1e-8
    k = torch.where(small, 0.5 - a2 / 48.0, torch.sin(0.5 * a) / a)
    w = torch.where(small, 1.0 - a2 / 8.0, torch.cos(0.5 * a))
    return q_norm(torch.cat([w, aa * k], -1))


def q_log(q):
    q = q_norm(q)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    w = q[..., :1].clamp(-1.0, 1.0)
    v = q[..., 1:]
    vn = torch.sqrt((v * v).sum(-1, keepdim=True))
    ang = 2.0 * torch.atan2(vn, w)
    k = torch.where(vn < 1e-8, 2.0 / w.clamp(min=1e-12), ang / vn.clamp(min=1e-12))
    return v * k


def _pinhole(p, fx, fy, cx, cy, px):
    """Pinhole residual (..., 2) and its Jacobian in the point (..., 2, 3);
    points behind the camera get a clamped residual."""
    z = p[..., 2]
    near = z.abs() < 1e-6
    eps = torch.full_like(z, 1e-6)
    zs = torch.where(near, torch.where(z < 0, -eps, eps), z)
    r = torch.stack([fx * p[..., 0] / zs + cx, fy * p[..., 1] / zs + cy], -1) - px
    zero = torch.zeros_like(z)
    dz = torch.where(near, zero, 1.0)
    J = torch.stack([torch.stack([fx / zs, zero, -fx * p[..., 0] / (zs * zs) * dz], -1),
                     torch.stack([zero, fy / zs, -fy * p[..., 1] / (zs * zs) * dz], -1)], -2)
    front = (z > 1e-6)[..., None]
    kept = front | (r.abs() < 1e4)
    return torch.where(front, r, r.clamp(-1e4, 1e4)), J * kept[..., None]


def q_matrix(q):
    w, x, y, z = q_norm(q).unbind(-1)
    m = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)], -2)


def reprojection(cam: dict, t, q, lm, px, pxr, has_r, jacobians: bool = True):
    """Stereo residuals r (N, 4) of observations at poses (t, q) (N, ...) of
    landmarks lm (N, 3), and with `jacobians` their Jacobians in the pose
    retraction (t + dt, q * exp(dtheta)) (N, 4, 6) and in the landmark
    (N, 4, 3). `cam` holds fx..cy, fx_r..cy_r, R_cr, t_cr (camera -> body)
    and R_rl, t_rl (x_right = R_rl x_left + t_rl) as tensors."""
    R = q_matrix(q)
    p_rob = torch.einsum("nji,nj->ni", R, lm - t)
    A = cam["R_cr"].T
    p_l = torch.einsum("ij,nj->ni", A, p_rob - cam["t_cr"])
    p_r = torch.einsum("ij,nj->ni", cam["R_rl"], p_l) + cam["t_rl"]
    r_l, J_l = _pinhole(p_l, cam["fx"], cam["fy"], cam["cx"], cam["cy"], px)
    r_r, J_r = _pinhole(p_r, cam["fx_r"], cam["fy_r"], cam["cx_r"], cam["cy_r"], pxr)
    hr = has_r[:, None]
    r = torch.cat([r_l, r_r * hr], -1)
    if not jacobians:
        return r
    Rt = R.transpose(-1, -2)
    d_pose = torch.cat([-Rt, skew(p_rob)], -1)  # d p_rob / d (dt, dtheta)
    B_l = J_l @ A  # d r_l / d p_rob
    B_r = J_r @ cam["R_rl"] @ A * hr[..., None]
    B = torch.cat([B_l, B_r], -2)  # (N, 4, 3)
    return r, B @ d_pose, B @ Rt


def odometry(t_i, q_i, t_j, q_j, t_m, q_m):
    """Weighted relative-pose residuals (Q, 6): translation x 30, rotation x 60."""
    qii = q_inv(q_i)
    rt = (q_rot(qii, t_j - t_i) - t_m) * 30.0
    rr = q_log(q_mul(q_inv(q_m), q_mul(qii, q_j))) * 60.0
    return torch.cat([rt, rr], -1)


def odometry_lin(t_i, q_i, t_j, q_j, t_m, q_m, h: float = 1e-6):
    """Odometry residuals and their Jacobians in both poses' retractions
    (Q, 6, 6) each, by central differences in float64, every perturbation
    evaluated in one batch."""
    a = [x.to(torch.float64) for x in (t_i, q_i, t_j, q_j, t_m, q_m)]
    Q, dev = a[0].shape[0], a[0].device
    steps = torch.cat([torch.zeros(1, 12, dtype=torch.float64, device=dev),
                       h * torch.eye(12, dtype=torch.float64, device=dev),
                       -h * torch.eye(12, dtype=torch.float64, device=dev)])  # (25, 12)
    d = steps[:, None, :].expand(25, Q, 12).reshape(-1, 12)
    rep = lambda x: x.repeat(25, 1)
    r = odometry(rep(a[0]) + d[:, :3], q_mul(rep(a[1]), q_exp(d[:, 3:6])), rep(a[2]) + d[:, 6:9],
                 q_mul(rep(a[3]), q_exp(d[:, 9:])), rep(a[4]), rep(a[5])).reshape(25, Q, 6)
    J = ((r[1:13] - r[13:]) / (2 * h)).permute(1, 2, 0)  # (Q, 6, 12)
    return r[0], J[..., :6], J[..., 6:]


def cam_tensors(cam: dict, dtype, device) -> dict:
    out = {}
    for k, v in cam.items():
        out[k] = torch.as_tensor(np.asarray(v, np.float64), device=device).to(dtype) if np.ndim(v) else float(v)
    return out


class Problem:
    """The problem on `device` in `dtype`: poses (P, 3) + (P, 4),
    landmarks (L, 3), observations (L, O) with a validity mask."""

    def __init__(self, arrays: dict, cam: dict, device, dtype=torch.float64):
        self.dtype = dtype
        self.wdtype = torch.float32 if dtype == torch.bfloat16 else dtype
        t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)
        self.t0, self.q0, self.lm0 = t(arrays["poses_t"]), t(arrays["poses_q"]), t(arrays["landmarks"])
        self.obs_pose = torch.as_tensor(arrays["obs_pose"], device=device).long()
        self.valid = torch.as_tensor(arrays["obs_valid"], device=device)
        sel = self.valid.reshape(-1)
        L, O = self.valid.shape
        self.op = self.obs_pose.reshape(-1)[sel]
        self.ol = torch.arange(L, device=device)[:, None].expand(L, O).reshape(-1)[sel]
        self.px, self.pxr = t(arrays["pixel"]).reshape(-1, 2)[sel], t(arrays["pixel_right"]).reshape(-1, 2)[sel]
        self.hr = torch.ones(self.op.shape[0], dtype=dtype, device=device)
        self.odom_t, self.odom_q = t(arrays["odom_t"]), t(arrays["odom_q"])
        f32 = lambda v: float(np.float32(v))
        c = {k: f32(cam[k]) for k in ("fx", "fy", "cx", "cy", "fx_r", "fy_r", "cx_r", "cy_r")}
        c.update(R_cr=np.eye(3), t_cr=np.zeros(3), R_rl=np.eye(3), t_rl=[-f32(cam["baseline"]), 0.0, 0.0])
        self.cam = cam_tensors(c, dtype, device)
        self.P, self.L = self.t0.shape[0], self.lm0.shape[0]

    def _odom(self, t, q, jacobians=False):
        args = (t[:-1], q[:-1], t[1:], q[1:], self.odom_t, self.odom_q)
        if jacobians:
            return tuple(x.to(self.wdtype) for x in odometry_lin(*args))
        return odometry(*args)

    def cost(self, t, q, lm) -> float:
        r = reprojection(self.cam, t[self.op], q[self.op], lm[self.ol], self.px, self.pxr, self.hr, False)
        n = torch.sqrt((r * r).sum(-1))
        rho = torch.where(n <= 4.0, 0.5 * n * n, 4.0 * (n - 2.0))
        ro = self._odom(t, q)
        w = self.wdtype
        return float(rho.to(w).sum() + 0.5 * (ro * ro).to(w).sum())

    def step(self, t, q, lm, lam: float):
        """The damped Gauss-Newton step (d_pose (P, 6), d_lm (L, 3))."""
        P, L, dev, w = self.P, self.L, t.device, self.wdtype
        pose, lmi = self.op, self.ol
        r, Jp, Jl = reprojection(self.cam, t[pose], q[pose], lm[lmi], self.px, self.pxr, self.hr)
        n = torch.sqrt((r * r).sum(-1))
        hw = torch.where(n <= 4.0, torch.ones_like(n), torch.sqrt(4.0 / n.clamp(min=1e-12)))
        r, Jp, Jl = (r * hw[:, None]).to(w), (Jp * hw[:, None, None]).to(w), (Jl * hw[:, None, None]).to(w)
        ro, Ji, Jj = self._odom(t, q, jacobians=True)

        V = torch.zeros(L, 3, 3, dtype=w, device=dev).index_add_(0, lmi, Jl.mT @ Jl)
        trace = V.diagonal(dim1=-2, dim2=-1).sum(-1)
        damp = torch.clamp(1e-5 * trace / 3.0, min=lam)
        V = V + damp[:, None, None] * torch.eye(3, dtype=w, device=dev)
        Vinv = torch.linalg.inv(V)
        g_lm = -torch.zeros(L, 3, dtype=w, device=dev).index_add_(0, lmi, (Jl.mT @ r[..., None])[..., 0])
        g_p = -torch.zeros(P, 6, dtype=w, device=dev).index_add_(0, pose, (Jp.mT @ r[..., None])[..., 0])
        g_p[:-1] -= (Ji.mT @ ro[..., None])[..., 0]
        g_p[1:] -= (Jj.mT @ ro[..., None])[..., 0]
        S = torch.zeros(P, P, 6, 6, dtype=w, device=dev)
        idx = torch.arange(P, device=dev)
        S[idx, idx] += torch.zeros(P, 6, 6, dtype=w, device=dev).index_add_(0, pose, Jp.mT @ Jp)
        S[idx[:-1], idx[:-1]] += Ji.mT @ Ji
        S[idx[1:], idx[1:]] += Jj.mT @ Jj
        S[idx[:-1], idx[1:]] += Ji.mT @ Jj
        S[idx[1:], idx[:-1]] += Jj.mT @ Ji
        S[idx, idx] += lam * torch.eye(6, dtype=w, device=dev)
        # The coupling W V^-1 W^T, landmark by landmark, over the (L, O) slots.
        O = self.valid.shape[1]
        slot = torch.full((L * O,), -1, dtype=torch.long, device=dev)
        slot[self.valid.reshape(-1).nonzero()[:, 0]] = torch.arange(pose.shape[0], device=dev)
        slot = slot.reshape(L, O)
        ok = slot >= 0
        Wb = torch.where(ok[..., None, None], (Jp.mT @ Jl)[slot.clamp(min=0)], 0.0)  # (L, O, 6, 3)
        Y = Wb @ Vinv[:, None]
        b = g_p.clone()
        b.index_add_(0, self.obs_pose.reshape(-1), -(Y @ g_lm[:, None, :, None])[..., 0].reshape(-1, 6))
        for a in range(O):
            C = Y[:, a, None] @ Wb.mT  # (L, O, 6, 6)
            pa = self.obs_pose[:, a, None].expand(L, O)
            flat = (pa * P + self.obs_pose).reshape(-1)
            S.view(P * P, 6, 6).index_add_(0, flat, -C.reshape(-1, 6, 6))
        S2 = S.permute(0, 2, 1, 3).reshape(6 * P, 6 * P)
        free = torch.ones(6 * P, dtype=w, device=dev)
        free[:6] = 0.0
        S2 = S2 * free[:, None] * free[None, :] + torch.diag(1.0 - free)
        bb = b.reshape(-1) * free
        d = torch.rsqrt(S2.diagonal().clamp(min=1e-20))
        Se = S2 * d[:, None] * d[None, :] + 1e-3 * torch.eye(6 * P, dtype=w, device=dev)
        chol, info = torch.linalg.cholesky_ex(Se)
        if int(info) != 0:
            return None
        x = torch.cholesky_solve((bb * d)[:, None], chol)[:, 0] * d
        d_pose = x.reshape(P, 6)
        rhs = g_lm - (Wb.mT @ d_pose[self.obs_pose][..., None])[..., 0].sum(1)
        return d_pose, (Vinv @ rhs[..., None])[..., 0]


def solve(prob: Problem, max_iterations: int = 15):
    """LM from the initial state; returns (t, q, lm, cost, iterations)."""
    t, q, lm = prob.t0, prob.q0, prob.lm0
    lam, cost = 1e-3, prob.cost(t, q, lm)
    accepted = streak = 0
    it = 0
    for it in range(1, max_iterations + 1):
        lam32 = float(np.float32(lam))
        s = prob.step(t, q, lm, lam32)
        new = math.nan
        if s is not None:
            dp, dl = s
            dp, dl = dp.to(prob.dtype), dl.to(prob.dtype)
            ct, cq, cl = t + dp[:, :3], q_norm(q_mul(q, q_exp(dp[:, 3:]))), lm + dl
            new = prob.cost(ct, cq, cl)
        if math.isfinite(new) and new < cost:
            rel = (cost - new) / max(cost, 1e-12)
            t, q, lm, cost = ct, cq, cl, new
            lam = max(lam * 0.4, 1e-9)
            accepted += 1
            streak = 0
            stop = rel < 1e-6
        else:
            lam = min(lam * (4.0 if math.isfinite(new) else 64.0), 1e6)
            streak += 1
            stop = lam >= 1e6 or (streak >= 4 and accepted > 0)
        if stop:
            break
    return t, q, lm, cost, it
