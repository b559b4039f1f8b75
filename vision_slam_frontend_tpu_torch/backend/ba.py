"""Levenberg-Marquardt bundle adjustment with Schur-complement solves (port
of backend/ba.py).

  - Landmark blocks V_l (3x3) are eliminated exactly per landmark (batched
    closed-form inverses): the classic Schur complement.
  - The reduced camera system S = U - W V^{-1} W^T is solved either densely
    (S assembled on the device, its coupling W V^{-1} W^T in the JAX
    package's compensated bfloat16 arithmetic; one Cholesky) or matrix-free by
    preconditioned CG (block-Jacobi preconditioner from U's diagonal).
  - The gauge is fixed by freezing pose 0; LM damping with accept/reject on
    the true cost.

Everything runs where the BAProblem's tensors live. The step has no host
sync: the LM loop syncs once per iteration, on the candidate cost. Every
reduction is deterministic on the GPU, so two runs of one problem give
bit-equal results: large sums are dense gathers + sums over the pose-major
and landmark-major gather tables (backend/tracks.build_gather_tables), and
the remaining scatter-adds (`_scatter_add_`) take each device's
deterministic form.

The products here run in float32 with TF32 off: TF32 raises S's assembly
error from about 1e-7 to about 1e-3 of |S|, past the 1e-3 equilibrated ridge
that keeps the factorization positive definite, so `optimize` refuses a
CUDA problem while `torch.backends.cuda.matmul.allow_tf32` is set.
"""

from __future__ import annotations

import dataclasses
import itertools
import os

import numpy as np
import torch

from vision_slam_frontend_tpu_torch.backend.residuals import (
    CameraParams,
    _apply_pose_delta,
    huber_weights,
    linearize_odometry,
    linearize_reprojection,
    linearize_reprojection_pm,
    odometry_residuals,
    reprojection_residuals,
)
from vision_slam_frontend_tpu_torch.geometry.rotation import quat_normalize
from vision_slam_frontend_tpu_torch.types.slam_types import BAProblem
from vision_slam_frontend_tpu_torch.utils.profiling import count, recording, span


@dataclasses.dataclass
class BASolverConfig:
    max_iterations: int = 15
    cg_iterations: int = 64
    # Read by nothing: _run_pcg runs exactly cg_iterations, as the JAX
    # package's does. Kept so that both packages' configs take the same fields.
    cg_tol: float = 1e-8
    init_lambda: float = 1e-3
    lambda_up: float = 4.0
    lambda_down: float = 0.4
    huber_delta: float = 4.0  # pixels; <= 0 disables
    odom_t_weight: float = 30.0  # 1/sigma: ~3 cm translation noise
    odom_r_weight: float = 60.0  # ~1 deg rotation noise
    fix_first_pose: bool = True
    # Inner linear solver for the reduced camera system:
    #   "auto"  — dense Cholesky for P <= dense_max_poses (with gather
    #             tables), matrix-free PCG otherwise (the JAX package's rule);
    #   "dense" — always assemble S and factor it;
    #   "pcg"   — always matrix-free PCG;
    #   "dense_chunked", "pcg_chunked" — the JAX package's multi-program
    #             forms of dense and PCG; here they run the same single-program
    #             dense and PCG solves.
    schur_solver: str = "auto"
    dense_max_poses: int = 2048
    # The JAX package's windows for its chunked forms; here they select the
    # same single-program math ("auto" between dense_max_poses and this
    # runs dense; empty by default).
    dense_chunked_max_poses: int = 2048
    chunked_obs_threshold: int = 2_000_000
    # Sanitizer mode: validate each solver step on the host before applying
    # it (utils/checks.check_ba_step).
    validate: bool = False
    # Outlier trimming: after each LM convergence, drop observations whose
    # reprojection residual exceeds this (pixels) and re-optimize.
    trim_threshold: float = 0.0  # <= 0 disables
    trim_rounds: int = 2


def save_solver_checkpoint(path: str, problem: BAProblem, state: dict) -> None:
    """Atomically snapshot BA solver state mid-run: the problem's arrays
    (the JAX package's keys and dtypes) and the LM state (round, iteration,
    lambda, cost history, accepted and trimmed counts) in one npz."""
    data = {"ba_" + k: v for k, v in problem.to_numpy().items()}
    data["st_round"] = np.int64(state["round"])
    data["st_iter"] = np.int64(state["iter"])
    data["st_lambda"] = np.float64(state["lambda"])
    data["st_history"] = np.asarray(state["history"], np.float64)
    data["st_accepted"] = np.int64(state["accepted"])
    data["st_trimmed"] = np.int64(state["trimmed"])
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # file object: savez won't append ".npz"
        np.savez_compressed(f, **data)
    os.replace(tmp, path)


def load_solver_checkpoint(path: str, device="cuda") -> tuple[BAProblem, dict]:
    """Restore (BAProblem on `device`, the GPU unless the caller names the
    CPU; solver-state dict) saved by either package's save_solver_checkpoint."""
    with np.load(path) as raw:
        data = dict(raw)
    arrays = {f.name: data["ba_" + f.name] for f in dataclasses.fields(BAProblem) if "ba_" + f.name in data}
    state = {
        "round": int(data["st_round"]),
        "iter": int(data["st_iter"]),
        "lambda": float(data["st_lambda"]),
        "history": [float(x) for x in data["st_history"]],
        "accepted": int(data["st_accepted"]),
        "trimmed": int(data["st_trimmed"]),
    }
    return BAProblem.from_numpy(arrays, device=device), state


def _scatter_add_(out, ids, data):
    """out[ids[n]] += data[n] along dim 0, deterministically: on CUDA through
    index_put_(accumulate=True), which sorts the indices (index_add_ there
    uses atomics); on the CPU through index_add_ (index_put_'s accumulation
    there is the nondeterministic one)."""
    if out.is_cuda:
        return out.index_put_((ids,), data, accumulate=True)
    return out.index_add_(0, ids, data)


def _segsum(data, ids, num):
    """Rows of `data` summed into `num` segments by `ids`, deterministically."""
    return _scatter_add_(data.new_zeros((num,) + tuple(data.shape[1:])), ids, data)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _sym3_inv(M):
    """Batched closed-form inverse of symmetric 3x3 blocks (adjugate)."""
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m11, m12, m22 = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m12
    c01 = m02 * m12 - m01 * m22
    c02 = m01 * m12 - m02 * m11
    c11 = m00 * m22 - m02 * m02
    c12 = m01 * m02 - m00 * m12
    c22 = m00 * m11 - m01 * m01
    det = m00 * c00 + m01 * c01 + m02 * c02
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    inv = torch.stack(
        [
            torch.stack([c00, c01, c02], -1),
            torch.stack([c01, c11, c12], -1),
            torch.stack([c02, c12, c22], -1),
        ],
        -2,
    )
    return inv / det[..., None, None]


def _per_row(lm_damping, rows: int):
    """LM damping for each of `rows` rows: a number as it is; a (n,) tensor,
    one lambda per segment of a folded problem (parallel/segment_ba), whose
    poses and landmarks split into n equal consecutive blocks, as (rows, 1, 1)."""
    if torch.is_tensor(lm_damping):
        return lm_damping.repeat_interleave(rows // lm_damping.shape[0])[:, None, None]
    return lm_damping


def _huber(r, Jp, Jl, huber_delta):
    """IRLS-weighted residual rows and Jacobians."""
    w = huber_weights(r, huber_delta)[..., None]
    return r * w, Jp * w[..., None], Jl * w[..., None]


def _linearize_odom(problem: BAProblem, odom_t_weight, odom_r_weight):
    return linearize_odometry(
        problem.poses_t, problem.poses_q, problem.odom_i, problem.odom_j,
        problem.odom_t, problem.odom_q, problem.odom_mask, odom_t_weight, odom_r_weight,
    )


def _linearize(cam, problem: BAProblem, huber_delta, odom_t_weight, odom_r_weight, cfg_huber_enabled: bool):
    """Residuals + Jacobians for all factors (flat), with IRLS robust weights."""
    r, Jp, Jl = linearize_reprojection(
        cam, problem.poses_t, problem.poses_q, problem.landmarks,
        problem.obs_pose, problem.obs_landmark, problem.obs_pixel, problem.obs_mask,
        problem.obs_pixel_right, problem.obs_right_mask,
    )
    if cfg_huber_enabled:
        r, Jp, Jl = _huber(r, Jp, Jl, huber_delta)
    return (r, Jp, Jl) + _linearize_odom(problem, odom_t_weight, odom_r_weight)


def _build_pm_inputs(problem: BAProblem):
    """One-time gather of the observation inputs into pose-major (P, Mp)
    layout; every LM iteration then linearizes directly pose-major. Rebuilt
    per optimize round because trimming changes obs_mask."""
    tbl = problem.pose_obs  # (P, Mp) flat observation indices
    mask = problem.pose_obs_mask & problem.obs_mask[tbl]
    pm = {
        "landmark": problem.obs_landmark[tbl],  # (P, Mp)
        "pixel": problem.obs_pixel[tbl],  # (P, Mp, 2)
        "mask": mask,  # (P, Mp) bool
        "pixel_right": None,
        "right_mask": None,
    }
    if problem.obs_pixel_right is not None:
        pm["pixel_right"] = problem.obs_pixel_right[tbl]
        pm["right_mask"] = problem.obs_right_mask[tbl] & mask
    return pm


def _linearize_pm(cam, problem: BAProblem, pm, huber_delta, odom_t_weight, odom_r_weight, cfg_huber_enabled: bool):
    """Pose-major residuals + Jacobians (reprojection) + odometry terms."""
    r, Jp, Jl = linearize_reprojection_pm(
        cam, problem.poses_t, problem.poses_q, problem.landmarks,
        pm["landmark"], pm["pixel"], pm["mask"], pm["pixel_right"], pm["right_mask"],
    )
    if cfg_huber_enabled:
        r, Jp, Jl = _huber(r, Jp, Jl, huber_delta)
    return (r, Jp, Jl) + _linearize_odom(problem, odom_t_weight, odom_r_weight)


def reprojection_costs(cam, problem: BAProblem, huber_delta, cfg_huber_enabled: bool):
    """Each observation's robust reprojection cost (N,), masked: the terms
    compute_cost sums (a sharded or segmented caller sums them itself)."""
    r = reprojection_residuals(
        cam, problem.poses_t, problem.poses_q, problem.landmarks,
        problem.obs_pose, problem.obs_landmark, problem.obs_pixel, problem.obs_mask,
        problem.obs_pixel_right, problem.obs_right_mask,
    )
    if not cfg_huber_enabled:
        return 0.5 * torch.sum(r * r, dim=-1)
    norm = torch.linalg.norm(r, dim=-1)
    rho = torch.where(norm <= huber_delta, 0.5 * norm**2, huber_delta * (norm - 0.5 * huber_delta))
    return rho * problem.obs_mask


def odometry_cost(problem: BAProblem, odom_t_weight, odom_r_weight):
    """The odometry factors' cost terms 0.5 |r|^2, (Q,)."""
    ro = odometry_residuals(
        problem.poses_t, problem.poses_q, problem.odom_i, problem.odom_j,
        problem.odom_t, problem.odom_q, problem.odom_mask, odom_t_weight, odom_r_weight,
    )
    return 0.5 * torch.sum(ro * ro, dim=-1)


def compute_cost(cam, problem: BAProblem, huber_delta, odom_t_weight, odom_r_weight, cfg_huber_enabled: bool):
    """True robustified cost (not the IRLS quadratic), a 0-d tensor."""
    if cfg_huber_enabled:
        reproj_cost = torch.sum(reprojection_costs(cam, problem, huber_delta, True))
    else:
        r = reprojection_residuals(
            cam, problem.poses_t, problem.poses_q, problem.landmarks,
            problem.obs_pose, problem.obs_landmark, problem.obs_pixel, problem.obs_mask,
            problem.obs_pixel_right, problem.obs_right_mask,
        )
        reproj_cost = 0.5 * torch.sum(r * r)
    ro = odometry_residuals(
        problem.poses_t, problem.poses_q, problem.odom_i, problem.odom_j,
        problem.odom_t, problem.odom_q, problem.odom_mask, odom_t_weight, odom_r_weight,
    )
    return reproj_cost + 0.5 * torch.sum(ro * ro)


def _odom_terms(problem: BAProblem, Ji, Jj, ro, P):
    """Odometry-factor gradient and U-diagonal contributions (small Q: the
    deterministic scatter is fine here)."""
    g = -_segsum(torch.einsum("qij,qi->qj", Ji, ro), problem.odom_i, P)
    g = g - _segsum(torch.einsum("qij,qi->qj", Jj, ro), problem.odom_j, P)
    U = _segsum(torch.einsum("qij,qik->qjk", Ji, Ji), problem.odom_i, P)
    U = U + _segsum(torch.einsum("qij,qik->qjk", Jj, Jj), problem.odom_j, P)
    return g, U


def _odom_apply(Ji, Jj, odom_i, odom_j, x, P):
    """The odometry factors' J^T J applied to x (P, 6)."""
    yo = torch.einsum("qij,qj->qi", Ji, x[odom_i]) + torch.einsum("qij,qj->qi", Jj, x[odom_j])
    u = _segsum(torch.einsum("qij,qi->qj", Ji, yo), odom_i, P)
    return u + _segsum(torch.einsum("qij,qi->qj", Jj, yo), odom_j, P)


def _free_mask(problem: BAProblem, fix_first: bool, dtype):
    """(P,) 1 for a free pose, 0 for a frozen one (the gauge)."""
    fixed = torch.arange(problem.num_poses, device=problem.device) == (0 if fix_first else -1)
    if problem.pose_fixed is not None:
        fixed = fixed | problem.pose_fixed
    return (~fixed).to(dtype)


def _run_pcg(b, S_apply, M_apply, cg_iters: int):
    """A fixed number of preconditioned CG iterations, no host sync."""
    x = torch.zeros_like(b)
    rr = b
    z = M_apply(rr)
    p = z
    rz = torch.sum(rr * z)
    for _ in range(cg_iters):
        Sp = S_apply(p)
        denom = torch.sum(p * Sp)
        alpha = torch.where(denom.abs() > 1e-20, rz / denom, 0.0)
        x = x + alpha * p
        rr2 = rr - alpha * Sp
        z2 = M_apply(rr2)
        rz2 = torch.sum(rr2 * z2)
        beta = torch.where(rz.abs() > 1e-20, rz2 / rz, 0.0)
        p = z2 + beta * p
        rr, rz = rr2, rz2
    return x, rr


def _lm_reduce(x_pm, lm_tbl, lm_mask):
    """(P, Mp, D) -> (L, D): the pose-major-to-landmark gather + masked sum."""
    P, Mp = x_pm.shape[:2]
    flat = x_pm.reshape(P * Mp, x_pm.shape[-1])
    return torch.sum(flat[lm_tbl] * lm_mask, dim=1)


def _schur_terms(pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem: BAProblem, lm_damping, fix_first: bool,
                 trace_floor: bool):
    """What both Schur solves build once per step from pose-major inputs:
    the damped landmark blocks V and V^{-1}, the gauge mask, the landmark
    gradient g_lm, the reduced right-hand side b and U's damped block
    diagonal. Returns a dict of them and of the layout tensors."""
    P = problem.num_poses
    L = problem.num_landmarks
    pm_mask = pm["mask"].to(r_pm.dtype)[..., None]  # (P, Mp, 1)
    lm_tbl = problem.lm_obs  # (L, Ml) indices into flat (P*Mp)
    lm_mask = problem.lm_obs_mask.to(r_pm.dtype)[..., None]  # (L, Ml, 1)
    ol_pm = pm["landmark"]  # (P, Mp) landmark id per slot
    Mp = ol_pm.shape[1]

    # --- Landmark blocks.
    VV = torch.einsum("pmij,pmik->pmjk", Jl_pm, Jl_pm).reshape(P, Mp, 9)
    V = _lm_reduce(VV, lm_tbl, lm_mask).reshape(L, 3, 3)
    damping = _per_row(lm_damping, L)
    if trace_floor:
        # Trace-relative damping floor (the dense path's): with plain
        # lm_damping (~1e-3) against V ~ 1e6, cond(V) reaches ~1e9 and the
        # f32 3x3 Cholesky's pivot cancellation produces garbage factors (B
        # inflates, the exact S built from it is indefinite). Flooring
        # per-landmark damping at 1e-5 of the local trace caps cond(V) at
        # ~3e5; it applies to the factorization, elimination and
        # back-substitution alike (per-landmark-scaled LM damping).
        trV = V[..., 0, 0] + V[..., 1, 1] + V[..., 2, 2]
        damping = (1e-5 * trV / 3.0)[..., None, None].clamp(min=damping)
    V = V + damping * _eye(3, V)[None]
    V_inv = _sym3_inv(V)
    free = _free_mask(problem, fix_first, r_pm.dtype)

    # --- Gradients and the reduced RHS b = g_pose - W V^{-1} g_lm.
    g_odom, U_odom = _odom_terms(problem, Ji, Jj, ro, P)
    g_pose = -torch.einsum("pmij,pmi->pj", Jp_pm, r_pm) + g_odom
    g_lm = -_lm_reduce(torch.einsum("pmij,pmi->pmj", Jl_pm, r_pm), lm_tbl, lm_mask)
    s = torch.einsum("ljk,lk->lj", V_inv, g_lm)  # (L, 3)
    s_pm = s[ol_pm] * pm_mask  # (P, Mp, 3)
    Jls = torch.einsum("pmij,pmj->pmi", Jl_pm, s_pm)
    b = (g_pose - torch.einsum("pmij,pmi->pj", Jp_pm, Jls)) * free[:, None]

    U_diag = torch.einsum("pmij,pmik->pjk", Jp_pm, Jp_pm) + U_odom
    U_diag = U_diag + _per_row(lm_damping, P) * _eye(6, U_diag)[None]
    return dict(V=V, V_inv=V_inv, free=free, g_lm=g_lm, b=b, U_diag=U_diag, pm_mask=pm_mask,
                lm_tbl=lm_tbl, lm_mask=lm_mask, ol_pm=ol_pm)


def _pm_build_from_pm(pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem: BAProblem, lm_damping, fix_first: bool):
    """Every one-time product of a Schur-PCG step, from pose-major inputs.

    Returns (state, b, g_lm): `state` is what the CG step and the
    back-substitution consume.
    """
    t = _schur_terms(pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem, lm_damping, fix_first, trace_floor=False)
    state = {
        "Jp_pm": Jp_pm, "Jl_pm": Jl_pm, "ol_pm": t["ol_pm"], "pm_mask": t["pm_mask"],
        "lm_tbl": t["lm_tbl"], "lm_mask": t["lm_mask"], "V_inv": t["V_inv"],
        # Block-Jacobi preconditioner; inv_ex checks nothing on the host (no sync).
        "M_inv": torch.linalg.inv_ex(t["U_diag"]).inverse,
        "Ji": Ji, "Jj": Jj, "odom_i": problem.odom_i, "odom_j": problem.odom_j,
        "free": t["free"], "lam": lm_damping,
    }
    return state, t["b"], t["g_lm"]


def _pm_sapply(state, x):
    """Apply the reduced camera system S = U + lam*I - W V^{-1} W^T.

    Each product is a broadcast multiply and a sum over the contracted axis.
    As einsums they become cuBLAS batched matrix-vector calls, and those over
    millions of 4x3 (slot) and 3x3 (landmark) blocks are 10-20x slower on the
    GPU: at 4.5M slots, Jl^T y took 5.8 ms against 0.31, Jl V^{-1}t 4.0 against
    0.44, V^{-1} t 0.80 against 0.075, Jp^T y 0.94 against 0.59 (H100)."""
    free = state["free"]
    Jp_pm, Jl_pm = state["Jp_pm"], state["Jl_pm"]
    x = x * free[:, None]
    y = (Jp_pm * x[:, None, None, :]).sum(-1)  # (P, Mp, D), gather-free
    u = (Jp_pm * y[..., None]).sum((1, 2)) + state["lam"] * x
    u = u + _odom_apply(state["Ji"], state["Jj"], state["odom_i"], state["odom_j"], x, x.shape[0])
    # Coupling through the eliminated landmarks.
    t = _lm_reduce((Jl_pm * y[..., None]).sum(2), state["lm_tbl"], state["lm_mask"])  # (L, 3)
    st = (state["V_inv"] * t[:, None, :]).sum(-1)
    st_pm = st[state["ol_pm"]] * state["pm_mask"]  # (P, Mp, 3)
    z2 = (Jl_pm * st_pm[:, :, None, :]).sum(-1)
    z = (Jp_pm * z2[..., None]).sum((1, 2))
    return (u - z) * free[:, None]


def _pm_mapply(state, x):
    return torch.einsum("pij,pj->pi", state["M_inv"], x) * state["free"][:, None]


def _backsub(Jp_pm, Jl_pm, lm_tbl, lm_mask, V_inv, g_lm, d_pose):
    """Landmark back-substitution from pose-major inputs:
    d_lm = V^{-1}(g_lm - W^T d_pose)."""
    y = torch.einsum("pmij,pj->pmi", Jp_pm, d_pose)
    wtd = _lm_reduce(torch.einsum("pmij,pmi->pmj", Jl_pm, y), lm_tbl, lm_mask)
    return torch.einsum("ljk,lk->lj", V_inv, g_lm - wtd)


def _pm_backsub(state, g_lm, d_pose):
    return _backsub(state["Jp_pm"], state["Jl_pm"], state["lm_tbl"], state["lm_mask"], state["V_inv"], g_lm, d_pose)


def _solve_schur_pcg_posemajor_from_pm(
    pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem: BAProblem, lm_damping, cg_iters: int, fix_first: bool,
    stats: dict | None = None,
):
    """Pose-major Schur-PCG from the pose-major linearization. Returns
    (d_pose (P, 6), d_lm (L, 3), |CG residual|). With a `stats` dict, also
    puts there "cg_residual_rel", |CG residual| / |b| as a device scalar."""
    with span("ba.assemble"):
        state, b, g_lm = _pm_build_from_pm(pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem, lm_damping, fix_first)
    with span("ba.linear_solve"):
        with span("ba.pcg"):
            d_pose, rr = _run_pcg(b, lambda x: _pm_sapply(state, x), lambda x: _pm_mapply(state, x), cg_iters)
        with span("ba.backsub"):
            d_lm = _pm_backsub(state, g_lm, d_pose)
        res = torch.linalg.norm(rr)
        if stats is not None:
            stats["cg_residual_rel"] = res / torch.linalg.norm(b)
        return d_pose, d_lm, res


def _chol3(V):
    """Batched closed-form Cholesky of SPD 3x3 blocks: V = G G^T, G lower."""
    eps = 1e-12
    a11 = V[..., 0, 0].clamp(min=eps)
    l11 = torch.sqrt(a11)
    l21 = V[..., 1, 0] / l11
    l31 = V[..., 2, 0] / l11
    l22 = torch.sqrt((V[..., 1, 1] - l21 * l21).clamp(min=eps))
    l32 = (V[..., 2, 1] - l31 * l21) / l22
    l33 = torch.sqrt((V[..., 2, 2] - l31 * l31 - l32 * l32).clamp(min=eps))
    z = torch.zeros_like(l11)
    return torch.stack(
        [
            torch.stack([l11, z, z], -1),
            torch.stack([l21, l22, z], -1),
            torch.stack([l31, l32, l33], -1),
        ],
        -2,
    )


def _inv_lower3(G):
    """Batched inverse of lower-triangular 3x3 blocks."""
    l11, l21, l31 = G[..., 0, 0], G[..., 1, 0], G[..., 2, 0]
    l22, l32, l33 = G[..., 1, 1], G[..., 2, 1], G[..., 2, 2]
    i11 = 1.0 / l11
    i22 = 1.0 / l22
    i33 = 1.0 / l33
    i21 = -l21 * i11 * i22
    i32 = -l32 * i22 * i33
    i31 = (l21 * l32 - l31 * l22) * i11 * i22 * i33
    z = torch.zeros_like(i11)
    return torch.stack(
        [
            torch.stack([i11, z, z], -1),
            torch.stack([i21, i22, z], -1),
            torch.stack([i31, i32, i33], -1),
        ],
        -2,
    )


def _s_init(U_diag, Ji, Jj, odom_i, odom_j, block_poses: int | None = None):
    """S's block diagonal and odometry coupling blocks, block-major
    (P, Pb, 6, 6): S4[p, q % Pb] is S's 6x6 block of poses p and q. Pb
    (`block_poses`, default P) is the width of S's diagonal blocks: a folded
    problem of P / Pb independent segments (parallel/segment_ba) keeps only
    them, every pair of poses that shares a factor lying in one segment."""
    P = U_diag.shape[0]
    Pb = block_poses or P
    S4 = U_diag.new_zeros(P, Pb, 6, 6)
    ar = torch.arange(P, device=U_diag.device)
    S4[ar, ar % Pb] = U_diag
    if odom_i is not None:
        Koff = torch.einsum("qia,qib->qab", Ji, Jj)  # zero on masked factors
        flat = S4.view(P * Pb, 36)
        _scatter_add_(flat, odom_i * Pb + odom_j % Pb, Koff.reshape(-1, 36))
        _scatter_add_(flat, odom_j * Pb + odom_i % Pb, Koff.transpose(1, 2).reshape(-1, 36))
    return S4


def _split_bf16(x):
    """x (..., 3) = hi + mid + lo, each part a bfloat16 value held in x's
    dtype (the JAX package's three-way split of the coupling's Bt), stacked
    as (..., 3 parts, 3)."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    r = x - hi
    mid = r.to(torch.bfloat16).to(x.dtype)
    return torch.stack((hi, mid, (r - mid).to(torch.bfloat16).to(x.dtype)), -2)


def _slot_groups(pose_of, mask):
    """The (landmark, pose) groups of the landmark-major observation slots
    (pose_of, mask: (L, Ml)): (place (L, Ml, Ml) bool, slot b's parts sum
    into slot a: a is its group's first valid slot, b a valid slot of that
    group; first (L, Ml) bool, a slot that heads its group)."""
    same = (pose_of[:, :, None] == pose_of[:, None, :]) & mask[:, :, None] & mask[:, None, :]
    idx = torch.arange(pose_of.shape[1], device=pose_of.device)
    first = mask & ~(same & (idx[None, None, :] < idx[None, :, None])).any(-1)
    return same & first[:, :, None], first


def _group_pairs(pose_of, mask):
    """Every pair (a, b) of one landmark's (landmark, pose) groups, each
    named by its first slot: (lm, a, b, place), place as _slot_groups'."""
    place, first = _slot_groups(pose_of, mask)
    lm, a, b = (first[:, :, None] & first[:, None, :]).nonzero(as_tuple=True)
    return lm, a, b, place


def placed_parts(Bt, place):
    """The JAX package's placement of Bt (L, Ml, 6, 3) (its _bbt_compensated's
    place(), a dot_general with a bfloat16 output): per (landmark, pose), the
    hi, mid and lo parts of that pose's slots summed in float32 (one batched
    product over the three parts side by side) and each sum rounded once to
    bfloat16. Each sum is held on its group's first slot (`place`,
    _slot_groups'), the other slots are zero. Returns (L, Ml, 6, 3, 3), the
    parts on axis 3 (_split_bf16's), in Bt's dtype."""
    L, Ml = Bt.shape[:2]
    parts = _split_bf16(Bt)
    summed = torch.bmm(place.to(Bt.dtype), parts.reshape(L, Ml, 54)).view_as(parts)
    return summed.to(torch.bfloat16).to(Bt.dtype)


def _compensated_slabs(parts):
    """A block's bfloat16 parts (..., 6, 3, 3) (hi, mid, lo on axis -2, as
    _split_bf16 stacks them) laid side by side as a left slab [h, m, h, m, h,
    l] and a right slab [h, m, m, h, l, h], each (..., 6, 18): a's left slab
    times b's right slab transposed is hh + mm + hm + mh + hl + lh (ml and
    ll dropped), every product exact and the sum float32."""
    h, m, l = parts.unbind(-2)
    return torch.cat((h, m, h, m, h, l), -1), torch.cat((h, m, m, h, l, h), -1)


def _six_products(pa, pb):
    """hh + mm + hm + mh + hl + lh of two (n, 6, 3) blocks' bfloat16 parts
    (pa, pb: (n, 6, 3, 3), _split_bf16's) as one batched product over
    _compensated_slabs: the JAX package's six products with float32 sums;
    ml and ll dropped."""
    return torch.bmm(_compensated_slabs(pa)[0], _compensated_slabs(pb)[1].transpose(1, 2))


def _coupling_blocks(Bt, lm, a, b, place):
    """The coupling term's 6x6 blocks B_p B_q^T, one per pair of (landmark,
    pose) groups of a _group_pairs plan, in the JAX package's arithmetic:
    Bt = W G^{-T} placed per group (placed_parts), then the six products of
    the two groups' parts (_six_products' one batched product), group a's
    on the left. (n, 6, 6)."""
    left, right = _compensated_slabs(placed_parts(Bt, place))  # (L, Ml, 6, 18) each
    return torch.bmm(left[lm, a], right[lm, b].transpose(1, 2))


def _dense_coupling_plan(problem: BAProblem, block_poses: int | None = None):
    """The coupling term's static plan, built once per round (one host
    sync): every pair of (landmark, pose) groups of each landmark, a group
    being the landmark's valid slots on one pose (the benchmark draws
    observers with replacement, so a landmark can hold two slots on a pose).
    Returns (lm, a, b, target, place): the pairs by their groups' first
    slots a, b (_group_pairs), each pair's target block pose(a) * Pb +
    pose(b) % Pb in _s_init's layout, and the groups' placement (L, Ml, Ml)."""
    Pb = block_poses or problem.num_poses
    pose_of = problem.lm_obs // problem.pose_obs.shape[1]  # (L, Ml) pose of each landmark-observation slot
    lm, a, b, place = _group_pairs(pose_of, problem.lm_obs_mask)
    return lm, a, b, pose_of[lm, a] * Pb + pose_of[lm, b] % Pb, place


def _dense_terms(
    pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem: BAProblem, lm_damping, fix_first: bool,
    block_poses: int | None = None,
):
    """_dense_assemble's terms before the coupling: (the Schur terms
    (_schur_terms'), S4 (P, Pb, 6, 6) without the coupling (_s_init's block
    diagonal and odometry blocks, float32), Bt = W G^{-T} (L, Ml, 6, 3) with
    W = Jp^T Jl per slot and V = G G^T)."""
    P = problem.num_poses
    L = problem.num_landmarks
    t = _schur_terms(pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem, lm_damping, fix_first, trace_floor=True)
    lm_tbl, lm_mask = t["lm_tbl"], t["lm_mask"]
    Mp, Ml = Jp_pm.shape[1], lm_tbl.shape[1]
    Ginv = _inv_lower3(_chol3(t["V"]))  # V^{-1} = Ginv^T Ginv
    S4 = _s_init(t["U_diag"], Ji, Jj, problem.odom_i, problem.odom_j, block_poses)
    W_pm = torch.einsum("pmij,pmik->pmjk", Jp_pm, Jl_pm)  # (P, Mp, 6, 3)
    W_lm = W_pm.reshape(P * Mp, 18)[lm_tbl].reshape(L, Ml, 6, 3) * lm_mask[..., None]
    return t, S4, torch.einsum("lmij,lcj->lmic", W_lm, Ginv)


def _dense_assemble(
    pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem: BAProblem, lm_damping, fix_first: bool, plan=None,
    block_poses: int | None = None,
):
    """The explicit reduced camera matrix of a damped GN step,
        S = U + lambda*I - B B^T,   B = W V^{-1/2}  (W = Jp^T Jl per pair),
    the block diagonal and odometry blocks in float32 (_dense_terms), the
    coupling B B^T in the JAX package's compensated bfloat16 arithmetic
    (_coupling_blocks: one 6x6 block per pair of each landmark's (landmark,
    pose) groups), reduced into S by the deterministic scatter. `plan` is
    _dense_coupling_plan(problem), built here when None; `block_poses` is
    _s_init's. Returns (S4 (P, Pb, 6, 6), b, free, V_inv, g_lm)."""
    t, S4, Bt = _dense_terms(pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem, lm_damping, fix_first, block_poses)
    lm, a, bb, target, place = _dense_coupling_plan(problem, block_poses) if plan is None else plan
    C = _coupling_blocks(Bt, lm, a, bb, place)  # S -= B B^T
    _scatter_add_(S4.view(-1, 36), target, -C.reshape(-1, 36))
    return S4, t["b"], t["free"], t["V_inv"], t["g_lm"]


def _dense_core(
    pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem: BAProblem, lm_damping, fix_first: bool, plan=None,
    block_poses: int | None = None,
):
    """One damped GN step through the explicit reduced camera matrix
    (_dense_assemble), solved with one Cholesky (_dense_solve_core; one per
    diagonal block of `block_poses` poses), then the landmarks'
    back-substitution. Returns (d_pose, d_lm, |residual|)."""
    with span("ba.assemble"):
        S4, b, free, V_inv, g_lm = _dense_assemble(
            pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem, lm_damping, fix_first, plan, block_poses,
        )
    with span("ba.linear_solve"):
        d_pose, rrn = _dense_solve_core(S4, b, free)
        lm_mask = problem.lm_obs_mask.to(g_lm.dtype)[..., None]
        return d_pose, _backsub(Jp_pm, Jl_pm, problem.lm_obs, lm_mask, V_inv, g_lm, d_pose), rrn


def _dense_solve_core(S4, b, free):
    """Gauge + exact Cholesky solve of the assembled reduced camera system
    S4 (P, Pb, 6, 6) (_s_init's layout): one matrix where Pb == P, else one
    per diagonal block of Pb poses, factored together. A failed
    factorization gives NaN (as the JAX package's Cholesky does) in its
    block's step, which the LM loop meets as a non-finite cost."""
    P, Pb = S4.shape[:2]
    n = P // Pb
    S2 = S4.reshape(n, Pb, Pb, 6, 6).permute(0, 1, 3, 2, 4).reshape(n, 6 * Pb, 6 * Pb)  # row 6p + i
    if n == 1:
        S2 = S2[0]
    free6 = free.repeat_interleave(6).reshape(S2.shape[:-1])
    S2 = S2 * free6[..., :, None] * free6[..., None, :]
    S2 = S2 + torch.diag_embed(1.0 - free6)
    # Jacobi equilibration: at small LM damping the raw S's condition number
    # reaches ~1e12 (diag spans rotation vs translation blocks and pose
    # observation counts), past what an f32 Cholesky can factor; scaling by
    # d = diag(S)^{-1/2} is exact (D S D with the solve rescaled).
    d = torch.rsqrt(torch.diagonal(S2, dim1=-2, dim2=-1).clamp(min=1e-20))
    S2e = S2 * d[..., :, None] * d[..., None, :]
    # Assembly-noise ridge (the JAX package's too): S's float32 sums and the
    # compensated bf16 coupling (ml and ll dropped) leave ~1e-7 relative
    # error of |S| where each (landmark, pose) holds one slot, more where a
    # group's summed parts are rounded to bf16 as they are placed; that
    # swamps the exact system's smallest eigenvalues at small LM damping.
    # A 1e-3 ridge on the EQUILIBRATED matrix is
    # Marquardt-style diag-relative damping: it keeps S positive definite
    # while perturbing the step by ~0.1% of each coordinate's curvature.
    S2e = S2e + 1e-3 * _eye(6 * Pb, S2e)
    chol, info = torch.linalg.cholesky_ex(S2e)  # no error check: no sync
    y = torch.linalg.solve_triangular(chol, (b.reshape(d.shape) * d)[..., None], upper=False)
    xe = torch.linalg.solve_triangular(chol.mT, y, upper=True)[..., 0]
    x = torch.where(info[..., None] == 0, xe * d, float("nan"))
    d_pose = x.reshape(P, 6) * free[:, None]
    Sx = S2 @ x if n == 1 else (S2 @ x[..., None])[..., 0]
    rr = b - Sx.reshape(P, 6)
    return d_pose, torch.linalg.norm(rr)


def _solve_schur_pcg_scatter(
    r, Jp, Jl, ro, Ji, Jj, problem: BAProblem, lm_damping, cg_iters: int, fix_first: bool,
):
    """Flat scatter-sum formulation, for problems without gather tables."""
    P = problem.num_poses
    L = problem.num_landmarks
    op = problem.obs_pose
    ol = problem.obs_landmark

    def reduce_pose(data):
        return _segsum(data, op, P)

    def reduce_lm(data):
        return _segsum(data, ol, L)

    with span("ba.assemble"):
        # --- Landmark blocks and their exact elimination.
        V = reduce_lm(torch.einsum("nij,nik->njk", Jl, Jl)) + lm_damping * _eye(3, Jl)[None]
        V_inv = _sym3_inv(V)

        # --- Gradients (RHS of the normal equations): g = -J^T r.
        g_odom, U_odom = _odom_terms(problem, Ji, Jj, ro, P)
        g_pose = -reduce_pose(torch.einsum("nij,ni->nj", Jp, r)) + g_odom
        g_lm = -reduce_lm(torch.einsum("nij,ni->nj", Jl, r))

        free = _free_mask(problem, fix_first, r.dtype)

        def gauge(x):
            return x * free[:, None]

        # --- Reduced RHS: b = g_pose - W V^{-1} g_lm.
        s = torch.einsum("ljk,lk->lj", V_inv, g_lm)
        Jls = torch.einsum("nij,nj->ni", Jl, s[ol])
        b = gauge(g_pose - reduce_pose(torch.einsum("nij,ni->nj", Jp, Jls)))

        # --- Block-Jacobi preconditioner from the U diagonal.
        U_diag = reduce_pose(torch.einsum("nij,nik->njk", Jp, Jp)) + U_odom
        U_diag = U_diag + lm_damping * _eye(6, U_diag)[None]
        M_inv = torch.linalg.inv_ex(U_diag).inverse

        def S_apply(x):
            x = gauge(x)
            y = torch.einsum("nij,nj->ni", Jp, x[op])
            u = reduce_pose(torch.einsum("nij,ni->nj", Jp, y))
            u = u + _odom_apply(Ji, Jj, problem.odom_i, problem.odom_j, x, P)
            u = u + lm_damping * x
            t = reduce_lm(torch.einsum("nij,ni->nj", Jl, y))
            st = torch.einsum("ljk,lk->lj", V_inv, t)
            Jlst = torch.einsum("nij,nj->ni", Jl, st[ol])
            return gauge(u - reduce_pose(torch.einsum("nij,ni->nj", Jp, Jlst)))

        def M_apply(x):
            return gauge(torch.einsum("pij,pj->pi", M_inv, x))

    with span("ba.linear_solve"):
        d_pose, rr = _run_pcg(b, S_apply, M_apply, cg_iters)

        # --- Landmark back-substitution: d_lm = V^{-1}(g_lm - W^T d_pose).
        y = torch.einsum("nij,nj->ni", Jp, d_pose[op])
        wtd = reduce_lm(torch.einsum("nij,ni->nj", Jl, y))
        d_lm = torch.einsum("ljk,lk->lj", V_inv, g_lm - wtd)
        return d_pose, d_lm, torch.linalg.norm(rr)


def _solve_schur_pcg_sharded(
    r, Jp, Jl, ro, Ji, Jj, problem: BAProblem, lm_damping, cg_iters: int, fix_first: bool, group,
):
    """The scatter Schur-PCG step of an observation-sharded problem
    (parallel/sharded_ba): each shard of `group` (parallel/mesh) holds a
    contiguous slice of the observations, poses and landmarks are
    replicated. Every sum over observations is a partial per shard,
    all-reduced: V, the landmark gradient and U in one all-reduce, the
    reduced right-hand side's pose sum in one, each CG iteration's S x in one
    of the (L, 3) landmark partial and one of the (P, 6) pose partial, the
    back-substitution in one of (L, 3). The odometry terms, the
    preconditioner and the CG scalars are computed alike on every shard from
    replicated values: no host round trip."""
    P = problem.num_poses
    L = problem.num_landmarks
    op = problem.obs_pose
    ol = problem.obs_landmark

    def reduce_pose(data):
        return group.all_reduce(group.segsum(data, op, P))

    def reduce_lm(data):
        return group.all_reduce(group.segsum(data, ol, L))

    with span("ba.assemble"):
        lm_part = group.segsum(
            torch.cat([torch.einsum("nij,nik->njk", Jl, Jl).reshape(-1, 9), torch.einsum("nij,ni->nj", Jl, r)], 1),
            ol, L,
        )
        pose_part = group.segsum(torch.einsum("nij,nik->njk", Jp, Jp).reshape(-1, 36), op, P)
        packed = group.all_reduce(torch.cat([lm_part.flatten(-2), pose_part.flatten(-2)], -1))
        lm_sums = packed[: 12 * L].view(L, 12)
        V_inv = _sym3_inv(lm_sums[:, :9].reshape(L, 3, 3) + lm_damping * _eye(3, Jl)[None])
        g_lm = -lm_sums[:, 9:]
        g_odom, U_odom = _odom_terms(problem, Ji, Jj, ro, P)
        U_diag = packed[12 * L:].view(P, 6, 6) + U_odom + lm_damping * _eye(6, Jp)[None]
        free = _free_mask(problem, fix_first, r.dtype)

        def gauge(x):
            return x * free[:, None]

        # b = g_pose - W V^{-1} g_lm = g_odom - sum_n Jp^T (r + Jl s).
        Jls = torch.einsum("nij,nj->ni", Jl, torch.einsum("ljk,lk->lj", V_inv, g_lm)[ol])
        b = gauge(g_odom - reduce_pose(torch.einsum("nij,ni->nj", Jp, r + Jls)))
        M_inv = torch.linalg.inv_ex(U_diag).inverse

        def S_apply(x):
            x = gauge(x)
            y = torch.einsum("nij,nj->ni", Jp, x[op])
            st = torch.einsum("ljk,lk->lj", V_inv, reduce_lm(torch.einsum("nij,ni->nj", Jl, y)))
            z = y - torch.einsum("nij,nj->ni", Jl, st[ol])  # (U - W V^{-1} W^T) x per observation
            u = reduce_pose(torch.einsum("nij,ni->nj", Jp, z))
            return gauge(u + _odom_apply(Ji, Jj, problem.odom_i, problem.odom_j, x, P) + lm_damping * x)

        def M_apply(x):
            return gauge(torch.einsum("pij,pj->pi", M_inv, x))

    with span("ba.linear_solve"):
        d_pose, rr = _run_pcg(b, S_apply, M_apply, cg_iters)
        y = torch.einsum("nij,nj->ni", Jp, d_pose[op])
        d_lm = torch.einsum("ljk,lk->lj", V_inv, g_lm - reduce_lm(torch.einsum("nij,ni->nj", Jl, y)))
        return d_pose, d_lm, torch.linalg.norm(rr)


def sharded_cost(cam, problem: BAProblem, huber_delta, odom_t_weight, odom_r_weight, cfg_huber_enabled: bool, group):
    """compute_cost of an observation-sharded problem: the reprojection
    terms' partial sums all-reduced, the replicated odometry terms added
    once."""
    return group.total(reprojection_costs(cam, problem, huber_delta, cfg_huber_enabled)) + torch.sum(
        odometry_cost(problem, odom_t_weight, odom_r_weight))


def refit_landmarks(cam, problem: BAProblem, huber_delta, iters: int, cfg_huber_enabled: bool):
    """Landmark-only Gauss-Newton refit with the poses held fixed: each
    landmark's 3x3 normal system is solved exactly and independently; each
    iteration decreases the reprojection cost in the Gauss-Newton sense."""
    L = problem.num_landmarks
    for _ in range(iters):
        r, _, Jl = linearize_reprojection(
            cam, problem.poses_t, problem.poses_q, problem.landmarks,
            problem.obs_pose, problem.obs_landmark, problem.obs_pixel, problem.obs_mask,
            problem.obs_pixel_right, problem.obs_right_mask,
        )
        if cfg_huber_enabled:
            w = huber_weights(r, huber_delta)[:, None]
            r = r * w
            Jl = Jl * w[..., None]
        if problem.lm_obs is not None:
            lm_mask = problem.lm_obs_mask.to(r.dtype)[..., None]
            # lm_obs indexes the pose-major flat (P*Mp) space; map back to
            # flat observation ids through pose_obs.
            flat_ids = problem.pose_obs.reshape(-1)[problem.lm_obs]
            r_lm = r[flat_ids] * lm_mask
            Jl_lm = Jl[flat_ids] * lm_mask[..., None]
            V = torch.einsum("lmij,lmik->ljk", Jl_lm, Jl_lm)
            g = -torch.einsum("lmij,lmi->lj", Jl_lm, r_lm)
        else:
            V = _segsum(torch.einsum("nij,nik->njk", Jl, Jl), problem.obs_landmark, L)
            g = -_segsum(torch.einsum("nij,ni->nj", Jl, r), problem.obs_landmark, L)
        tr = V[..., 0, 0] + V[..., 1, 1] + V[..., 2, 2]
        V = V + (1e-6 * tr[:, None, None] / 3.0 + 1e-9) * _eye(3, V)[None]
        d = torch.einsum("ljk,lk->lj", _sym3_inv(V), g)
        # Landmarks with no (valid) observations keep their value.
        d = torch.where((tr > 1e-12)[:, None], d, 0.0)
        problem = problem.replace(landmarks=problem.landmarks + d)
    return problem


def _apply_step(problem: BAProblem, d_pose, d_lm):
    t2, q2 = _apply_pose_delta(problem.poses_t, problem.poses_q, d_pose)
    return problem.replace(poses_t=t2, poses_q=quat_normalize(q2), landmarks=problem.landmarks + d_lm)


def _reproj_residual_norms(cam, problem: BAProblem):
    r = reprojection_residuals(
        cam, problem.poses_t, problem.poses_q, problem.landmarks,
        problem.obs_pose, problem.obs_landmark, problem.obs_pixel, problem.obs_mask,
        problem.obs_pixel_right, problem.obs_right_mask,
    )
    return torch.linalg.norm(r, dim=-1)


def _round_f32(x: float) -> float:
    """x rounded to float32, as the JAX package passes its solver scalars."""
    return float(np.float32(x))


def optimize(
    problem: BAProblem,
    config=None,
    solver: BASolverConfig | None = None,
    cam: CameraParams | None = None,
    verbose: bool = False,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 5,
    resume: bool = False,
    group=None,
):
    """Run LM to convergence (with optional outlier-trimming rounds), on the
    device the problem's tensors live on.

    With `checkpoint_path`, solver state is snapshotted every
    `checkpoint_every` LM iterations; `resume=True` restarts from the last
    snapshot if one exists (fresh run otherwise). With a shard `group`
    (parallel/mesh), `problem` is one of parallel/sharded_ba.shard_ba_problem
    and every step is the observation-sharded Schur-PCG.

    Returns (optimized BAProblem, info dict)."""
    solver = solver or BASolverConfig()
    if group is not None and checkpoint_path:
        raise ValueError("solver checkpoints hold one process's problem: not available for a sharded solve")
    device = problem.device
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "BA needs float32 products: torch.backends.cuda.matmul.allow_tf32 is on "
            "(TF32 puts S's assembly error past the factorization's ridge)"
        )
    if cam is None:
        if config is None:
            raise ValueError("need a FrontendConfig or CameraParams")
        cam = CameraParams.from_config(config, device=device)
    cam = cam.to(device)

    rounds = 1 + (solver.trim_rounds if solver.trim_threshold > 0 else 0)
    iteration_ids = _iteration_ids()
    total_info = None
    n_trimmed_total = 0
    resume_state = None
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        problem, resume_state = load_solver_checkpoint(checkpoint_path, device=device)
        n_trimmed_total = resume_state["trimmed"]
        if verbose:
            print(
                f"[BA] resuming from {checkpoint_path}: round "
                f"{resume_state['round']}, iter {resume_state['iter']}, "
                f"lambda={resume_state['lambda']:.2e}"
            )
    start_round = resume_state["round"] if resume_state else 0
    if solver.trim_threshold > 0 and resume_state is None:
        # Pre-trim at the INITIAL estimate: gross outliers are orders of
        # magnitude above the inlier residual scale before any optimization
        # pulls the estimate toward them.
        norms = _reproj_residual_norms(cam, problem)
        pre_mask = problem.obs_mask & (norms < 10.0 * solver.trim_threshold)
        n_pre = _count_dropped(problem.obs_mask, pre_mask, group)
        if verbose and n_pre:
            print(f"[BA] pre-trim @ {10.0 * solver.trim_threshold:.0f}px: removed {n_pre} observations")
        n_trimmed_total += n_pre
        problem = problem.replace(obs_mask=pre_mask)
    for rnd in range(start_round, rounds):
        rs = resume_state if (resume_state and rnd == start_round) else None
        ckpt_cb = None
        if checkpoint_path:
            def ckpt_cb(prob, st, _rnd=rnd):  # noqa: B023 — _rnd pins the loop var
                st = dict(st, round=_rnd, trimmed=n_trimmed_total)
                save_solver_checkpoint(checkpoint_path, prob, st)

        problem, info = _optimize_round(
            problem, solver, cam, verbose,
            resume_state=rs, ckpt_cb=ckpt_cb, checkpoint_every=checkpoint_every, group=group,
            iteration_ids=iteration_ids,
        )
        if total_info is None:
            total_info = info
        else:
            total_info = {
                "cost": info["cost"],
                "history": total_info["history"] + info["history"],
                "iterations": total_info["iterations"] + info["iterations"],
                "accepted": total_info["accepted"] + info["accepted"],
            }
        if rnd < rounds - 1:
            # Progressive schedule: loose first, tightening to trim_threshold
            # on the final round.
            thresh = solver.trim_threshold * (4.0 ** (rounds - 2 - rnd))
            norms = _reproj_residual_norms(cam, problem)
            new_mask = problem.obs_mask & (norms < thresh)
            n_trimmed = _count_dropped(problem.obs_mask, new_mask, group)
            if verbose:
                print(f"[BA] trim round {rnd} @ {thresh:.0f}px: removed {n_trimmed} observations")
            if n_trimmed == 0:
                break
            n_trimmed_total += n_trimmed
            problem = problem.replace(obs_mask=new_mask)
    total_info["trimmed"] = n_trimmed_total
    return problem, total_info


def _count_dropped(old_mask, new_mask, group) -> int:
    """Observations dropped from old_mask to new_mask, over every shard."""
    dropped = old_mask & ~new_mask
    return int(dropped.sum() if group is None else group.total(dropped.to(torch.float32)))


def _solver_form(problem: BAProblem, solver: BASolverConfig) -> str:
    """"dense", "pcg" (pose-major) or "pcg_scatter": the JAX package's
    dispatch, with its chunked forms mapped to the same single-program math.
    Dense needs the gather tables; without them every request runs the
    scatter PCG."""
    if problem.pose_obs is None:
        return "pcg_scatter"
    name = solver.schur_solver
    if name in ("dense", "dense_chunked"):
        return "dense"
    if name == "auto" and problem.num_poses <= max(solver.dense_max_poses, solver.dense_chunked_max_poses):
        return "dense"
    return "pcg"


_SOLVES = itertools.count()


def _iteration_ids():
    """The (solve, iteration) request ids of one solve's LM iterations,
    numbered across its trimming rounds."""
    solve = next(_SOLVES)
    return ((solve, k) for k in itertools.count())


def _optimize_round(
    problem: BAProblem,
    solver: BASolverConfig,
    cam: CameraParams,
    verbose: bool = False,
    resume_state: dict | None = None,
    ckpt_cb=None,
    checkpoint_every: int = 5,
    group=None,
    *,
    iteration_ids,
):
    """LM iterations to convergence at one trimming round. Each iteration is
    a `ba.iteration` span whose request is the next of `iteration_ids`
    (the solve's _iteration_ids()), with its stages as children:
    ba.linearize, ba.assemble, ba.linear_solve, ba.step (the candidate and
    its cost, enqueued) and ba.sync (the cost's fetch). The pose-major PCG
    step's linear solve holds ba.pcg and ba.backsub, and while a profiler
    records, its sync also fetches |CG residual| / |b| with the cost and
    counts it (`ba.cg_residual_rel`) beside `ba.cg_iterations`."""
    huber_on = solver.huber_delta > 0
    hd = _round_f32(solver.huber_delta)
    wt = _round_f32(solver.odom_t_weight)
    wr = _round_f32(solver.odom_r_weight)


    def cost_of(p):
        if group is None:
            return compute_cost(cam, p, hd, wt, wr, huber_on)
        return sharded_cost(cam, p, hd, wt, wr, huber_on, group)

    lam = solver.init_lambda
    cost = float(cost_of(problem))
    history = [cost]
    accepted = 0
    start_iter = 0
    if resume_state is not None:
        lam = resume_state["lambda"]
        history = list(resume_state["history"]) or [cost]
        cost = history[-1]
        accepted = resume_state["accepted"]
        start_iter = resume_state["iter"]
    rejected_streak = 0
    form = "pcg_sharded" if group is not None else _solver_form(problem, solver)
    if solver.schur_solver in ("dense", "dense_chunked") and form != "dense" and verbose:
        print("[BA] no gather tables: dense -> PCG")
    # Pose-major path: observation inputs re-laid-out once per round (the
    # graph is static within a round), then every iteration linearizes
    # directly pose-major.
    if form not in ("pcg_scatter", "pcg_sharded"):
        pm = _build_pm_inputs(problem)
        plan = _dense_coupling_plan(problem) if form == "dense" else None
    for it in range(start_iter, solver.max_iterations):
        with span("ba.iteration", next(iteration_ids)):
            lam32 = _round_f32(lam)
            stats = None
            if form in ("pcg_sharded", "pcg_scatter"):
                with span("ba.linearize"):
                    r, Jp, Jl, ro, Ji, Jj = _linearize(cam, problem, hd, wt, wr, huber_on)
                if form == "pcg_sharded":
                    d_pose, d_lm, cg_res = _solve_schur_pcg_sharded(
                        r, Jp, Jl, ro, Ji, Jj, problem, lam32, solver.cg_iterations, solver.fix_first_pose, group,
                    )
                else:
                    d_pose, d_lm, cg_res = _solve_schur_pcg_scatter(
                        r, Jp, Jl, ro, Ji, Jj, problem, lam32, solver.cg_iterations, solver.fix_first_pose,
                    )
            else:
                with span("ba.linearize"):
                    r_pm, Jp_pm, Jl_pm, ro, Ji, Jj = _linearize_pm(cam, problem, pm, hd, wt, wr, huber_on)
                if form == "dense":
                    d_pose, d_lm, cg_res = _dense_core(
                        pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem, lam32, solver.fix_first_pose, plan,
                    )
                else:
                    stats = {} if recording() else None
                    d_pose, d_lm, cg_res = _solve_schur_pcg_posemajor_from_pm(
                        pm, r_pm, Jp_pm, Jl_pm, ro, Ji, Jj, problem, lam32, solver.cg_iterations,
                        solver.fix_first_pose, stats,
                    )
            if solver.validate:
                from vision_slam_frontend_tpu_torch.utils.checks import check_ba_step

                check_ba_step(it, d_pose, d_lm)
            with span("ba.step"):
                candidate = _apply_step(problem, d_pose, d_lm)
                candidate_cost = cost_of(candidate)
            with span("ba.sync"):
                if stats is not None:  # recording: the counter rides the cost's fetch
                    rel = stats["cg_residual_rel"].to(candidate_cost.dtype)
                    new_cost, rel = torch.stack([candidate_cost, rel]).tolist()
                    count("ba.cg_iterations", solver.cg_iterations)
                    count("ba.cg_residual_rel", rel)
                else:
                    new_cost = float(candidate_cost)  # the iteration's one sync
            if verbose:
                print(
                    f"[BA] iter {it}: cost {cost:.4f} -> {new_cost:.4f} "
                    f"(lambda={lam:.2e}, |cg_res|={float(cg_res):.2e})"
                )
            if np.isfinite(new_cost) and new_cost < cost:
                rel = (cost - new_cost) / max(cost, 1e-12)
                problem = candidate
                cost = new_cost
                lam = max(lam * solver.lambda_down, 1e-9)
                accepted += 1
                rejected_streak = 0
                history.append(cost)
                stop = rel < 1e-6
            else:
                # Non-finite candidate = the damped system went numerically
                # indefinite (a failed Cholesky gives NaN); escalate lambda much
                # faster than a plain cost rejection.
                up = solver.lambda_up if np.isfinite(new_cost) else solver.lambda_up**3
                lam = min(lam * up, 1e6)
                rejected_streak += 1
                history.append(cost)
                # Plateau: repeated rejections after an acceptance mean the
                # attainable minimum; before the first acceptance keep escalating.
                stop = lam >= 1e6 or (rejected_streak >= 4 and accepted > 0)
            if ckpt_cb and checkpoint_every > 0 and (stop or (it + 1) % checkpoint_every == 0):
                ckpt_cb(problem, {"iter": it + 1, "lambda": lam, "history": history, "accepted": accepted})
        if stop:
            break
    return problem, {
        "cost": cost,
        "history": history,
        "iterations": len(history) - 1,
        "accepted": accepted,
    }
