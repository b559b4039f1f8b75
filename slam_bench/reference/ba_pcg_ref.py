"""Plain reference of offline bundle adjustment on the port's pose-major PCG
route: ba_ref's problem, residuals, cost and Levenberg-Marquardt schedule
(`solve` is ba_ref.solve), with the step of the system that route's
conjugate gradients approximate, every product in float64.

The system: landmark blocks V = sum Jl^T Jl + lambda I, pose blocks
U = sum Jp^T Jp + the odometry factors' J^T J + lambda I, the reduced camera
system S = U - W V^-1 W^T over all P poses with pose 0 fixed (its rows and
columns replaced by the identity's, its right-hand side zeroed), assembled
densely; then d_lm = V^-1 (g_lm - W^T d_pose). By default (`cg_iterations`
None) S is factored by a dense Cholesky factorisation and solved exactly; a
factorisation that fails gives no step, which the schedule meets as a
non-finite candidate. With `cg_iterations` n, S is solved as the route solves
it: n iterations of conjugate gradients from zero, preconditioned by U's
inverse 6x6 blocks, with the route's guards on a vanishing denominator.

Where the exact step departs from the port's (backend/ba._solve_schur_pcg_posemajor_from_pm):
  - it is S's exact solution; the port runs `cg_iterations` (64 by default)
    of block-Jacobi preconditioned CG from zero, so a gap between the two
    answers is that truncation (and float32 rounding);
Where both steps depart from the port's:
  - float64 throughout, where the port computes in float32;
  - the odometry Jacobians by central differences (ba_ref's), the port's in
    closed form;
  - S is assembled densely, (6P)^2 numbers (5.9 GB at P = 4,541), where the
    port applies it matrix-free.
Where ba_ref's step departs from these: its landmark damping floored at
1e-5 of each block's trace, and its equilibration of S by the diagonal with a
1e-3 ridge, are the dense route's, which the PCG route lacks.

Plain PyTorch; nothing of the program. `dtype=torch.bfloat16` is the
control: residuals, Jacobians and costs in bfloat16, sums and the solve in
float32.
"""

from __future__ import annotations

import torch

from slam_bench.reference import ba_ref

solve = ba_ref.solve


class Problem(ba_ref.Problem):
    """ba_ref's problem, whose `step` solves the PCG route's system: exactly
    (`cg_iterations` None) or by that many preconditioned CG iterations."""

    def __init__(self, arrays: dict, cam: dict, device, dtype=torch.float64, cg_iterations: int | None = None):
        super().__init__(arrays, cam, device, dtype)
        self.cg_iterations = cg_iterations

    def step(self, t, q, lm, lam: float):
        """The damped Gauss-Newton step (d_pose (P, 6), d_lm (L, 3)), or None
        where S does not factor."""
        P, L, dev, w = self.P, self.L, t.device, self.wdtype
        pose, lmi = self.op, self.ol
        r, Jp, Jl = ba_ref.reprojection(self.cam, t[pose], q[pose], lm[lmi], self.px, self.pxr, self.hr)
        n = torch.sqrt((r * r).sum(-1))
        hw = torch.where(n <= 4.0, torch.ones_like(n), torch.sqrt(4.0 / n.clamp(min=1e-12)))
        r, Jp, Jl = (r * hw[:, None]).to(w), (Jp * hw[:, None, None]).to(w), (Jl * hw[:, None, None]).to(w)
        ro, Ji, Jj = self._odom(t, q, jacobians=True)
        eye = lambda k: torch.eye(k, dtype=w, device=dev)

        V = torch.zeros(L, 3, 3, dtype=w, device=dev).index_add_(0, lmi, Jl.mT @ Jl) + lam * eye(3)
        Vinv = torch.linalg.inv(V)
        g_lm = -torch.zeros(L, 3, dtype=w, device=dev).index_add_(0, lmi, (Jl.mT @ r[..., None])[..., 0])
        g_p = -torch.zeros(P, 6, dtype=w, device=dev).index_add_(0, pose, (Jp.mT @ r[..., None])[..., 0])
        g_p[:-1] -= (Ji.mT @ ro[..., None])[..., 0]
        g_p[1:] -= (Jj.mT @ ro[..., None])[..., 0]

        # S as (P, P, 6, 6) blocks: U's diagonal blocks, the odometry couplings.
        U = torch.zeros(P, 6, 6, dtype=w, device=dev).index_add_(0, pose, Jp.mT @ Jp) + lam * eye(6)
        U[:-1] += Ji.mT @ Ji
        U[1:] += Jj.mT @ Jj
        S = torch.zeros(P, P, 6, 6, dtype=w, device=dev)
        idx = torch.arange(P, device=dev)
        S[idx, idx] += U
        S[idx[:-1], idx[1:]] += Ji.mT @ Jj
        S[idx[1:], idx[:-1]] += Jj.mT @ Ji
        # The coupling W V^-1 W^T, landmark by landmark, over the (L, O) slots.
        O = self.valid.shape[1]
        slot = torch.full((L * O,), -1, dtype=torch.long, device=dev)
        slot[self.valid.reshape(-1).nonzero()[:, 0]] = torch.arange(pose.shape[0], device=dev)
        slot = slot.reshape(L, O)
        Wb = torch.where((slot >= 0)[..., None, None], (Jp.mT @ Jl)[slot.clamp(min=0)], 0.0)  # (L, O, 6, 3)
        del r, Jp, Jl, slot
        Y = Wb @ Vinv[:, None]
        b = g_p.clone()
        b.index_add_(0, self.obs_pose.reshape(-1), -(Y @ g_lm[:, None, :, None])[..., 0].reshape(-1, 6))
        blocks = S.view(P * P, 6, 6)
        for a in range(O):
            flat = (self.obs_pose[:, a, None] * P + self.obs_pose).reshape(-1)
            blocks.index_add_(0, flat, -(Y[:, a, None] @ Wb.mT).reshape(-1, 6, 6))
        del Y, blocks

        # Row 6p + i; pose 0 fixed. In place: S is (6P)^2 numbers.
        S2 = S.permute(0, 2, 1, 3).reshape(6 * P, 6 * P)
        del S
        S2[:6] = 0.0
        S2[:, :6] = 0.0
        S2[:6, :6] = eye(6)
        b[0] = 0.0
        if self.cg_iterations is not None:
            d_pose = _pcg(S2, b, torch.linalg.inv(U), self.cg_iterations)
        else:
            chol, info = torch.linalg.cholesky_ex(S2)
            del S2
            if int(info) != 0:
                return None
            d_pose = torch.cholesky_solve(b.reshape(-1, 1), chol)[:, 0].reshape(P, 6)
            del chol
        rhs = g_lm - (Wb.mT @ d_pose[self.obs_pose][..., None])[..., 0].sum(1)
        return d_pose, (Vinv @ rhs[..., None])[..., 0]


def _pcg(S2, b, M, iterations: int):
    """`iterations` of conjugate gradients on S2 x = b (x (P, 6) from zero),
    preconditioned by the (P, 6, 6) blocks M, pose 0 held at zero; alpha and
    beta are 0 where their denominator's magnitude is at most 1e-20."""
    P = b.shape[0]
    free = torch.ones(P, 1, dtype=b.dtype, device=b.device)
    free[0] = 0.0
    S_apply = lambda v: (S2 @ (v * free).reshape(-1)).reshape(P, 6) * free
    M_apply = lambda v: (M @ v[..., None])[..., 0] * free
    x = torch.zeros_like(b)
    r = b * free
    z = M_apply(r)
    p = z
    rz = (r * z).sum()
    for _ in range(iterations):
        Sp = S_apply(p)
        denom = (p * Sp).sum()
        alpha = torch.where(denom.abs() > 1e-20, rz / denom, 0.0)
        x = x + alpha * p
        r = r - alpha * Sp
        z = M_apply(r)
        rz2 = (r * z).sum()
        beta = torch.where(rz.abs() > 1e-20, rz2 / rz, 0.0)
        p = z + beta * p
        rz = rz2
    return x
