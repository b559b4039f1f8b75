"""Distributed bundle adjustment over a shard group (port of
parallel/sharded_ba.py): observation-sharded Schur-PCG and landmark-sharded
dense Schur.

The JAX package places its collectives with GSPMD (observation-sharded
inputs) and shard_map (landmark-sharded dense). Here each formulation is
written once against parallel/mesh's shard group, whose reductions are
`torch.distributed` all-reduces between processes or sums over the shard axis
of an in-process group:

  - observation-sharded PCG (shard_ba_problem + optimize_sharded): each shard
    owns a contiguous slice of observations; poses and landmarks are
    replicated; V, the right-hand side, U and the cost are all-reduced
    partials, and each CG iteration's S x costs one all-reduce of the (L, 3)
    landmark partial and one of the (P, 6) pose partial
    (backend/ba._solve_schur_pcg_sharded);
  - landmark-sharded dense (build_lm_sharded + optimize_sharded_dense): each
    shard owns a contiguous block of landmark ids and all their
    observations, eliminates its landmarks locally, and contributes partial
    (P, 6) gradients and U and a partial reduced camera matrix, all-reduced
    (one all-reduce each); the Cholesky is replicated, and the landmark steps
    are gathered.
"""

from __future__ import annotations

import numpy as np
import torch

from vision_slam_frontend_tpu_torch.types.slam_types import BAProblem

_OBS_FIELDS = ("obs_pose", "obs_landmark", "obs_pixel", "obs_mask", "obs_pixel_right", "obs_right_mask")


def pad_observations(problem: BAProblem, multiple: int) -> BAProblem:
    """The observation arrays padded with masked slots (zeros) to a
    multiple of `multiple` rows."""
    pad = (-problem.num_observations) % multiple
    if not pad:
        return problem
    changes = {}
    for name in _OBS_FIELDS:
        x = getattr(problem, name)
        if x is not None:
            changes[name] = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return problem.replace(**changes)


def shard_ba_problem(problem: BAProblem, mesh) -> BAProblem:
    """The problem as the observation-sharded solve holds it: this shard's
    contiguous slice of the observation arrays (every row for an in-process
    group, whose shards split them evenly), poses, landmarks and odometry
    replicated, and no gather tables (they index the global observation
    order; the sharded solve uses the scatter formulation).

    The observation capacity must divide the group size (pad_observations).
    """
    n = mesh.size
    N = problem.num_observations
    if N % n != 0:
        raise ValueError(f"observation capacity {N} not divisible by mesh size {n}")
    rows = mesh.local_rows(N)
    changes = {name: getattr(problem, name)[rows] for name in _OBS_FIELDS if getattr(problem, name) is not None}
    return problem.replace(pose_obs=None, pose_obs_mask=None, lm_obs=None, lm_obs_mask=None, **changes)


def optimize_sharded(problem: BAProblem, mesh, config=None, solver=None, cam=None, verbose: bool = False):
    """Distributed optimize(): the same LM loop (trimming rounds included),
    observation-sharded. Returns (optimized BAProblem, info dict); results
    equal the single-device scatter PCG up to float reduction order."""
    from vision_slam_frontend_tpu_torch.backend.ba import optimize

    sharded = shard_ba_problem(problem, mesh)
    return optimize(sharded, config=config, solver=solver, cam=cam, verbose=verbose, group=mesh)


# ---------------------------------------------------------------------------
# Landmark-sharded dense Schur solver
# ---------------------------------------------------------------------------


def build_lm_sharded(problem: BAProblem, n: int, pad_multiple: int = 8):
    """Host-side prep: re-lay observations landmark-major into n equal shards
    (numpy, the JAX package's tables).

    Shard k owns landmark ids [k*L/n, (k+1)*L/n) and all their observations.
    Returns a dict of numpy arrays, observation arrays stacked (n, Ns, ...),
    per-shard landmark gather tables (n, Lb, Ml) indexing the shard's local
    observation slots. Requires L % n == 0.
    """
    from vision_slam_frontend_tpu_torch.parallel.segment_ba import _np

    L = int(problem.landmarks.shape[0])
    if L % n != 0:
        raise ValueError(f"landmark capacity {L} not divisible by mesh size {n}")
    Lb = L // n

    op = _np(problem.obs_pose)
    ol = _np(problem.obs_landmark)
    msk = _np(problem.obs_mask)
    pix = _np(problem.obs_pixel).astype(np.float32)
    N = op.shape[0]
    if problem.obs_pixel_right is not None:
        pix_r = _np(problem.obs_pixel_right).astype(np.float32)
        msk_r = _np(problem.obs_right_mask)
    else:
        pix_r = np.zeros((N, 2), np.float32)
        msk_r = np.zeros(N, bool)

    def pad(x):
        return max(pad_multiple, ((x + pad_multiple - 1) // pad_multiple) * pad_multiple)

    shard_of = np.where(msk, ol // Lb, -1)
    idxs = [np.nonzero(shard_of == k)[0] for k in range(n)]
    Ns = pad(max(max((len(i) for i in idxs), default=0), 1))
    counts = np.bincount(ol[msk], minlength=L)
    Ml = pad(max(int(counts.max()) if counts.size else 1, 1))

    s_op = np.zeros((n, Ns), np.int32)
    s_olg = np.zeros((n, Ns), np.int32)  # global landmark id (for gathers)
    s_oll = np.zeros((n, Ns), np.int32)  # local landmark id within the shard
    s_pix = np.zeros((n, Ns, 2), np.float32)
    s_msk = np.zeros((n, Ns), bool)
    s_pix_r = np.zeros((n, Ns, 2), np.float32)
    s_msk_r = np.zeros((n, Ns), bool)
    s_tbl = np.zeros((n, Lb, Ml), np.int32)
    s_tmsk = np.zeros((n, Lb, Ml), bool)
    for k, idx in enumerate(idxs):
        c = len(idx)
        # Landmark-major order within the shard keeps each landmark's
        # observations contiguous.
        idx = idx[np.argsort(ol[idx], kind="stable")]
        s_op[k, :c] = op[idx]
        s_olg[k, :c] = ol[idx]
        # Padding slots keep a VALID global landmark id (the shard's first)
        # so gathers stay in range; their mask is False and the linearizer
        # zeroes their residuals and Jacobians.
        s_olg[k, c:] = k * Lb
        s_oll[k] = s_olg[k] - k * Lb
        s_pix[k, :c] = pix[idx]
        s_msk[k, :c] = True
        s_pix_r[k, :c] = pix_r[idx]
        s_msk_r[k, :c] = msk_r[idx]
        # Slot of each observation within its landmark's row: its rank among
        # the shard's (landmark-sorted) observations of that landmark.
        loc = ol[idx] - k * Lb
        if c:
            first = np.searchsorted(loc, loc, side="left")
            slot = np.arange(c) - first
            s_tbl[k, loc, slot] = np.arange(c)
            s_tmsk[k, loc, slot] = True
    return {
        "op": s_op, "ol_g": s_olg, "ol_l": s_oll,
        "pix": s_pix, "msk": s_msk, "pix_r": s_pix_r, "msk_r": s_msk_r,
        "lm_tbl": s_tbl, "lm_msk": s_tmsk,
    }


def _lm_shard_inputs(data: dict, mesh, device) -> dict:
    """This process's part of build_lm_sharded's arrays as tensors: one
    shard's for a process group, every shard's laid end to end for an
    in-process group (slots, local landmark ids and tables offset into the
    flat arrays, so shard k's rows are the k-th of n equal blocks)."""
    n, Ns = data["op"].shape
    Lb = data["lm_tbl"].shape[1]
    shards = mesh.local_rows(n)
    j = np.arange(len(range(*shards.indices(n))))  # local shard index
    out = {}
    for name, x in data.items():
        x = x[shards]
        if name == "ol_l":
            x = x.astype(np.int64) + j[:, None] * Lb
        elif name == "lm_tbl":
            x = x.astype(np.int64) + j[:, None, None] * Ns
        elif x.dtype == np.int32:
            x = x.astype(np.int64)
        out[name] = torch.from_numpy(np.ascontiguousarray(x.reshape((-1,) + x.shape[2:]))).to(device)
    out["lm_shard"] = torch.from_numpy(np.repeat(j, Lb)).to(device)
    return out


def _lm_sharded_plan(d: dict, P: int):
    """The coupling's static pair plan of the local landmark block (one host
    sync, once per solve): every pair (a, b) of valid observation slots of
    each local landmark l, its target block pose(a) * P + pose(b), and the
    shard of l."""
    mask = d["lm_msk"]
    lm, a, b = (mask[:, :, None] & mask[:, None, :]).nonzero(as_tuple=True)
    pose_of = d["op"][d["lm_tbl"]]  # (Lb, Ml)
    return lm, a, b, pose_of[lm, a] * P + pose_of[lm, b], d["lm_shard"][lm]


def lm_sharded_dense_step(cam, problem: BAProblem, d: dict, plan, mesh, free, lam, hd, wt, wr, huber_on: bool):
    """One damped GN step of the landmark-sharded dense solve.

    The local landmark block is eliminated with no communication (V, its
    trace-floored damping, V^{-1} and the Cholesky factors G: the dense
    path's rules, backend/ba._schur_terms); the pose-side partials of the
    gradient, the right-hand side's coupling and U go in one all-reduce, the
    partial reduced camera matrix S (pairs of each local landmark's
    observations, float32, by the deterministic scatter) in one more. The
    small system is then solved alike on every shard
    (backend/ba._dense_solve_core: gauge, equilibration, the 1e-3 ridge, one
    Cholesky), and each shard back-substitutes its landmarks; the landmark
    steps are gathered. Returns (d_pose (P, 6), d_lm (L, 3), |residual|)."""
    from vision_slam_frontend_tpu_torch.backend.ba import (
        _chol3,
        _dense_solve_core,
        _eye,
        _huber,
        _inv_lower3,
        _odom_terms,
        _s_init,
        _sym3_inv,
    )
    from vision_slam_frontend_tpu_torch.backend.residuals import linearize_odometry, linearize_reprojection

    P = problem.num_poses
    op, ol_l, tbl = d["op"], d["ol_l"], d["lm_tbl"]
    lmm = d["lm_msk"].to(torch.float32)[..., None]
    r, Jp, Jl = linearize_reprojection(
        cam, problem.poses_t, problem.poses_q, problem.landmarks, op, d["ol_g"], d["pix"], d["msk"], d["pix_r"],
        d["msk_r"],
    )
    if huber_on:
        r, Jp, Jl = _huber(r, Jp, Jl, hd)
    ro, Ji, Jj = linearize_odometry(problem.poses_t, problem.poses_q, problem.odom_i, problem.odom_j,
                                    problem.odom_t, problem.odom_q, problem.odom_mask, wt, wr)

    def lm_reduce(x):  # (N, F) -> (Lb, F): gather + masked sum
        return torch.sum(x[tbl] * lmm, dim=1)

    # --- Local landmark elimination (no communication).
    V = lm_reduce(torch.einsum("nij,nik->njk", Jl, Jl).reshape(-1, 9)).reshape(-1, 3, 3)
    trV = V[..., 0, 0] + V[..., 1, 1] + V[..., 2, 2]
    V = V + (1e-5 * trV / 3.0)[..., None, None].clamp(min=lam) * _eye(3, V)[None]
    V_inv = _sym3_inv(V)
    Ginv = _inv_lower3(_chol3(V))  # V^{-1} = Ginv^T Ginv
    g_lm = -lm_reduce(torch.einsum("nij,ni->nj", Jl, r))
    Jls = torch.einsum("nij,nj->ni", Jl, torch.einsum("ljk,lk->lj", V_inv, g_lm)[ol_l])

    # --- Pose-side partials in one all-reduce: J_p^T r, J_p^T J_l s, U.
    pose_part = torch.cat([torch.einsum("nij,ni->nj", Jp, r), torch.einsum("nij,ni->nj", Jp, Jls),
                           torch.einsum("nij,nik->njk", Jp, Jp).reshape(-1, 36)], 1)
    sums = mesh.all_reduce(mesh.segsum(pose_part, op, P))
    g_odom, U_odom = _odom_terms(problem, Ji, Jj, ro, P)
    b = (-sums[:, :6] + g_odom - sums[:, 6:12]) * free[:, None]
    U_diag = sums[:, 12:].view(P, 6, 6) + U_odom + lam * _eye(6, V)[None]

    # --- Coupling partial: S -= B B^T over each local landmark's pairs.
    W = torch.einsum("nij,nik->njk", Jp, Jl)  # (N, 6, 3)
    Bt = torch.einsum("lmij,lcj->lmic", W.reshape(-1, 18)[tbl].reshape(*tbl.shape, 6, 3) * lmm[..., None], Ginv)
    lm, a, bb, target, shard = plan
    C = torch.einsum("nic,njc->nij", Bt[lm, a], Bt[lm, bb]).reshape(-1, 36)
    Sc = mesh.all_reduce(mesh.segsum(C, target, P * P, shard))
    S4 = _s_init(U_diag, Ji, Jj, problem.odom_i, problem.odom_j) - Sc.view(P, P, 6, 6)
    d_pose, rr = _dense_solve_core(S4, b, free)

    # --- Back-substitute the local landmark block, then gather the steps.
    y = torch.einsum("nij,nj->ni", Jp, d_pose[op])
    d_lm = torch.einsum("ljk,lk->lj", V_inv, g_lm - lm_reduce(torch.einsum("nij,ni->nj", Jl, y)))
    return d_pose, mesh.gather_rows(d_lm), rr


def optimize_sharded_dense(problem: BAProblem, mesh, config=None, solver=None, cam=None, verbose: bool = False):
    """Distributed LM with the landmark-sharded dense Schur step.

    Same accept/reject schedule as backend/ba.optimize (single round, no
    outlier trimming: pre-trim with the single-device path if needed). Every
    shard holds the whole problem and computes the candidate cost itself.
    Returns (optimized BAProblem, info dict)."""
    from vision_slam_frontend_tpu_torch.backend.ba import (
        BASolverConfig,
        _apply_step,
        _free_mask,
        _round_f32,
        compute_cost,
    )
    from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams

    solver = solver or BASolverConfig()
    device = problem.device
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("BA needs float32 products: torch.backends.cuda.matmul.allow_tf32 is on")
    if cam is None:
        if config is None:
            raise ValueError("need a FrontendConfig or CameraParams")
        cam = CameraParams.from_config(config)
    cam = cam.to(device)

    d = _lm_shard_inputs(build_lm_sharded(problem, mesh.size), mesh, device)
    plan = _lm_sharded_plan(d, problem.num_poses)
    free = _free_mask(problem, solver.fix_first_pose, torch.float32)
    huber_on = solver.huber_delta > 0
    hd = _round_f32(solver.huber_delta)
    wt = _round_f32(solver.odom_t_weight)
    wr = _round_f32(solver.odom_r_weight)

    lam = solver.init_lambda
    cost = float(compute_cost(cam, problem, hd, wt, wr, huber_on))
    history = [cost]
    accepted = 0
    rejected_streak = 0
    for it in range(solver.max_iterations):
        d_pose, d_lm, rr = lm_sharded_dense_step(cam, problem, d, plan, mesh, free, _round_f32(lam), hd, wt, wr,
                                                 huber_on)
        candidate = _apply_step(problem, d_pose, d_lm)
        new_cost = float(compute_cost(cam, candidate, hd, wt, wr, huber_on))
        if verbose:
            print(f"[BA-dist] iter {it}: cost {cost:.4f} -> {new_cost:.4f} "
                  f"(lambda={lam:.2e}, |res|={float(rr):.2e}, shards={mesh.size})")
        if np.isfinite(new_cost) and new_cost < cost:
            rel = (cost - new_cost) / max(cost, 1e-12)
            problem = candidate
            cost = new_cost
            lam = max(lam * solver.lambda_down, 1e-9)
            accepted += 1
            rejected_streak = 0
            history.append(cost)
            if rel < 1e-6:
                break
        else:
            up = solver.lambda_up if np.isfinite(new_cost) else solver.lambda_up**3
            lam = min(lam * up, 1e6)
            rejected_streak += 1
            history.append(cost)
            if lam >= 1e6 or rejected_streak >= 4:
                break
    return problem, {
        "cost": cost,
        "history": history,
        "iterations": len(history) - 1,
        "accepted": accepted,
    }
