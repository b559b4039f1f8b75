"""Segment-parallel bundle adjustment: pose-chain sharding for long
trajectories (port of parallel/segment_ba.py).

A two-level solver (the submap decomposition of large-scale SfM/SLAM):

  LEVEL A (parallel): the trajectory is split into contiguous keyframe
  SEGMENTS (segment k owns poses [k*base, (k+1)*base); the cores partition
  [0, P)). Every observation belongs to the segment owning its pose and acts
  on a local COPY of its landmark; every odometry factor inside a segment is
  solved there. Each segment runs LM with an exact dense Schur step under its
  own LOCAL GAUGE (its first pose frozen), its own lambda and its own
  accept. The JAX package vmaps the per-segment step; here the segments are
  folded into one problem whose pose, landmark and observation ids are
  offset by segment x capacity, so the single-problem linearization and
  dense assembly (backend/ba.py) build every segment's reduced camera matrix
  at once, as the diagonal blocks of one (P, Ps, 6, 6) S, factored by one
  batched Cholesky. Under a shard group the segments split over the ranks
  and level A needs no communication beyond each iteration's per-segment
  costs.

  LEVEL B (tiny, replicated): segments drift rigidly in their local gauges,
  so a global alignment solves for one SE(3) correction per segment (6*n_seg
  parameters, Gauss-Newton on a dense system) from the JUNCTION odometry
  factors (those crossing segment boundaries, which no segment sees) plus
  LANDMARK TIES (a landmark observed from several segments must map to the
  same world point under each segment's correction).

After scatter-back, the duplicated landmark copies are reconciled by a global
landmark-only refit (backend/ba.refit_landmarks). A sweep is kept only if the
TRUE global cost decreases, so the outer loop is monotone by construction; a
few PCG iterations on the joint problem (observation-sharded under a group)
polish the submap fixed point.

Segment BA is the only distributed mode whose dense solve per device shrinks
as the trajectory grows: the global 6P x 6P reduced camera system is never
formed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vision_slam_frontend_tpu_torch.types.slam_types import BAProblem


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def build_segments(problem: BAProblem, n_seg: int, offset: int = 0):
    """Partition a BAProblem into n_seg stacked fixed-capacity sub-problems
    (numpy, the JAX package's arrays).

    Segment k owns the poses between consecutive core edges (edges at
    offset + k*base, base = ceil(P/n_seg), clipped to [0, P]; segment 0
    starts at 0 and the last ends at P), every observation whose pose lies in
    that core (acting on a local copy of its landmark), and every odometry
    factor with both endpoints inside. The segment's first pose is frozen as
    its local gauge. A nonzero offset (alternated between sweeps) moves the
    junctions so poses at a boundary in one sweep are interior in the next.

    Returns (stacked BAProblem of numpy arrays with leading axis n_seg, info
    dict with the scatter-back tables plus the junction/tie data for the
    alignment step).
    """
    from vision_slam_frontend_tpu_torch.backend.tracks import build_gather_tables

    P = int(problem.poses_t.shape[0])
    if n_seg < 1 or n_seg > P:
        raise ValueError(f"n_seg={n_seg} invalid for P={P}")
    base = -(-P // n_seg)  # ceil
    offset = int(offset) % base if n_seg > 1 else 0
    edges = np.concatenate([[0], np.clip(offset + base * np.arange(1, n_seg), 0, P), [P]])
    Ps = int(np.max(edges[1:] - edges[:-1]))

    op = _np(problem.obs_pose)
    ol = _np(problem.obs_landmark)
    omask = _np(problem.obs_mask)
    opix = _np(problem.obs_pixel).astype(np.float32)
    N = op.shape[0]
    if problem.obs_pixel_right is not None:
        opix_r = _np(problem.obs_pixel_right).astype(np.float32)
        omask_r = _np(problem.obs_right_mask)
    else:
        opix_r = np.zeros((N, 2), np.float32)
        omask_r = np.zeros(N, bool)
    poses_t = _np(problem.poses_t).astype(np.float32)
    poses_q = _np(problem.poses_q).astype(np.float32)
    lms = _np(problem.landmarks).astype(np.float32)
    lm_mask_g = _np(problem.landmark_mask)

    def odom(x, shape, dtype):
        return _np(x).astype(dtype) if x is not None else np.zeros(shape, dtype)

    oi = odom(problem.odom_i, 0, np.int32)
    oj = odom(problem.odom_j, 0, np.int32)
    ot = odom(problem.odom_t, (0, 3), np.float32)
    oq = odom(problem.odom_q, (0, 4), np.float32)
    om = odom(problem.odom_mask, 0, bool)

    def seg_of(pose_ids):
        return np.clip(np.searchsorted(edges, pose_ids, side="right") - 1, 0, n_seg - 1)

    # Landmark ownership: the segment containing the landmark's first valid
    # observation (only the owner's copy scatters back).
    valid_idx = np.nonzero(omask)[0]
    first_obs = np.full(lms.shape[0], N, np.int64)
    np.minimum.at(first_obs, ol[valid_idx], valid_idx)
    seen = first_obs < N
    first_pose = np.where(seen, op[np.minimum(first_obs, max(N - 1, 0))], -1).astype(np.int64)
    owner = seg_of(first_pose)
    owner[first_pose < 0] = -1

    obs_seg = seg_of(op)
    seg_lms, seg_obs = [], []
    lm_local = np.zeros((n_seg, lms.shape[0]), np.int64)  # global -> local id
    for k in range(n_seg):
        mask_k = omask & (obs_seg == k)
        lm_in = np.zeros(lms.shape[0], bool)
        lm_in[ol[mask_k]] = True
        lm_in &= lm_mask_g
        lids = np.nonzero(lm_in)[0]
        seg_lms.append(lids)
        lm_local[k, lids] = np.arange(len(lids))
        seg_obs.append(np.nonzero(mask_k)[0])
    Ls = max(max((len(s) for s in seg_lms), default=0), 1)
    Ls = ((Ls + 7) // 8) * 8
    Nsg = max(max((len(s) for s in seg_obs), default=0), 1)
    Nsg = ((Nsg + 7) // 8) * 8

    # Odometry: interior factors go to their segment; junction factors feed
    # the level-B alignment.
    seg_of_i = seg_of(oi)
    seg_of_j = seg_of(oj)
    interior = om & (seg_of_i == seg_of_j)
    junction = om & (seg_of_i != seg_of_j)
    seg_odo = [np.nonzero(interior & (seg_of_i == k))[0] for k in range(n_seg)]
    Qs = max(max((len(s) for s in seg_odo), default=0), 1)

    s = {
        "poses_t": np.zeros((n_seg, Ps, 3), np.float32),
        "poses_q": np.zeros((n_seg, Ps, 4), np.float32),
        "pose_mask": np.zeros((n_seg, Ps), bool),
        "pose_fixed": np.zeros((n_seg, Ps), bool),
        "landmarks": np.zeros((n_seg, Ls, 3), np.float32),
        "landmark_mask": np.zeros((n_seg, Ls), bool),
        "obs_pose": np.zeros((n_seg, Nsg), np.int32),
        "obs_landmark": np.zeros((n_seg, Nsg), np.int32),
        "obs_pixel": np.zeros((n_seg, Nsg, 2), np.float32),
        "obs_mask": np.zeros((n_seg, Nsg), bool),
        "obs_pixel_right": np.zeros((n_seg, Nsg, 2), np.float32),
        "obs_right_mask": np.zeros((n_seg, Nsg), bool),
        "odom_i": np.zeros((n_seg, Qs), np.int32),
        "odom_j": np.zeros((n_seg, Qs), np.int32),
        "odom_t": np.zeros((n_seg, Qs, 3), np.float32),
        "odom_q": np.zeros((n_seg, Qs, 4), np.float32),
        "odom_mask": np.zeros((n_seg, Qs), bool),
    }
    s["poses_q"][..., 0] = 1.0
    s["odom_q"][..., 0] = 1.0
    info = {
        "pose_gid": np.zeros((n_seg, Ps), np.int64),
        "pose_own": np.zeros((n_seg, Ps), bool),
        "lm_gid": np.zeros((n_seg, Ls), np.int64),
        "lm_own": np.zeros((n_seg, Ls), bool),
        "base": base,
    }

    tables = []
    for k in range(n_seg):
        lo, hi = int(edges[k]), int(edges[k + 1])
        npose = hi - lo
        s["poses_t"][k, :npose] = poses_t[lo:hi]
        s["poses_q"][k, :npose] = poses_q[lo:hi]
        s["pose_mask"][k, :npose] = True
        info["pose_gid"][k, :npose] = np.arange(lo, hi)
        info["pose_own"][k, :npose] = True
        # Local gauge: the segment's first pose is frozen; its rigid error is
        # absorbed by the level-B correction. Unused slots frozen too.
        s["pose_fixed"][k, 0] = True
        s["pose_fixed"][k, npose:] = True

        lids = seg_lms[k]
        nl = len(lids)
        s["landmarks"][k, :nl] = lms[lids]
        s["landmark_mask"][k, :nl] = True
        info["lm_gid"][k, :nl] = lids
        info["lm_own"][k, :nl] = owner[lids] == k

        obs = seg_obs[k]
        no = len(obs)
        s["obs_pose"][k, :no] = op[obs] - lo
        s["obs_landmark"][k, :no] = lm_local[k, ol[obs]]
        s["obs_pixel"][k, :no] = opix[obs]
        s["obs_mask"][k, :no] = True
        s["obs_pixel_right"][k, :no] = opix_r[obs]
        s["obs_right_mask"][k, :no] = omask_r[obs]

        odo = seg_odo[k]
        nq = len(odo)
        s["odom_i"][k, :nq] = oi[odo] - lo
        s["odom_j"][k, :nq] = oj[odo] - lo
        s["odom_t"][k, :nq] = ot[odo]
        s["odom_q"][k, :nq] = oq[odo]
        s["odom_mask"][k, :nq] = om[odo]

        tables.append(build_gather_tables(s["obs_pose"][k], s["obs_landmark"][k], s["obs_mask"][k], Ps, Ls))

    # Pad the per-segment gather tables to common widths and stack.
    Mp = max(t[0].shape[1] for t in tables)
    Ml = max(t[2].shape[1] for t in tables)
    s["pose_obs"] = np.zeros((n_seg, Ps, Mp), np.int32)
    s["pose_obs_mask"] = np.zeros((n_seg, Ps, Mp), bool)
    s["lm_obs"] = np.zeros((n_seg, Ls, Ml), np.int32)
    s["lm_obs_mask"] = np.zeros((n_seg, Ls, Ml), bool)
    for k, (po, pom, lo_t, lom) in enumerate(tables):
        s["pose_obs"][k, :, : po.shape[1]] = po
        s["pose_obs_mask"][k, :, : pom.shape[1]] = pom
        # lm_obs holds POSE-MAJOR flat indices (row*Mp_k + col); re-map to
        # the common width Mp so the solver's flat (Ps*Mp) space is right.
        Mp_k = po.shape[1]
        s["lm_obs"][k, :, : lo_t.shape[1]] = (lo_t // Mp_k) * Mp + (lo_t % Mp_k)
        s["lm_obs_mask"][k, :, : lom.shape[1]] = lom

    # --- Level-B data: junction odometry factors ...
    jn = np.nonzero(junction)[0]
    info["jn_a"] = seg_of_i[jn].astype(np.int32)
    info["jn_b"] = seg_of_j[jn].astype(np.int32)
    info["jn_ia"] = (oi[jn] - edges[info["jn_a"]]).astype(np.int32)
    info["jn_jb"] = (oj[jn] - edges[info["jn_b"]]).astype(np.int32)
    info["jn_t"] = ot[jn]
    info["jn_q"] = oq[jn]

    # ... and landmark ties: consecutive segment pairs sharing a landmark.
    copies = np.zeros((lms.shape[0], n_seg), bool)
    for k in range(n_seg):
        copies[seg_lms[k], k] = True
    tie_a, tie_b, tie_la, tie_lb, tie_lid = [], [], [], [], []
    for j in np.nonzero(copies.sum(1) >= 2)[0]:
        segs = np.nonzero(copies[j])[0]
        for a, b in zip(segs[:-1], segs[1:]):
            tie_a.append(a)
            tie_b.append(b)
            tie_la.append(lm_local[a, j])
            tie_lb.append(lm_local[b, j])
            tie_lid.append(j)
    info["tie_a"] = np.asarray(tie_a, np.int32)
    info["tie_b"] = np.asarray(tie_b, np.int32)
    info["tie_la"] = np.asarray(tie_la, np.int32)
    info["tie_lb"] = np.asarray(tie_lb, np.int32)
    info["tie_lid"] = np.asarray(tie_lid, np.int32)
    return BAProblem(**s), info


def fold_segments(stacked: BAProblem, segments: slice, device) -> BAProblem:
    """Segments `segments` of build_segments' stacked problem as ONE problem
    on `device`: poses, landmarks, observations and odometry factors laid
    end to end, each id offset by its segment's index times the capacity,
    the gather tables likewise. No observation or factor crosses segments,
    so the folded problem's normal equations are the segments', side by
    side."""
    k = len(range(*segments.indices(stacked.poses_t.shape[0])))
    Ps, Ls = stacked.poses_t.shape[1], stacked.landmarks.shape[1]
    Nsg, Mp = stacked.obs_pose.shape[1], stacked.pose_obs.shape[2]
    seg = np.arange(k)

    def flat(name, offset=None):
        x = getattr(stacked, name)[segments]
        if offset is not None:
            x = x.astype(np.int64) + (seg * offset).reshape((k,) + (1,) * (x.ndim - 1))
        return x.reshape((-1,) + x.shape[2:])

    arrays = {name: flat(name) for name in (
        "poses_t", "poses_q", "pose_mask", "pose_fixed", "landmarks", "landmark_mask", "obs_pixel", "obs_mask",
        "obs_pixel_right", "obs_right_mask", "odom_t", "odom_q", "odom_mask", "pose_obs_mask", "lm_obs_mask")}
    arrays.update(obs_pose=flat("obs_pose", Ps), obs_landmark=flat("obs_landmark", Ls), odom_i=flat("odom_i", Ps),
                  odom_j=flat("odom_j", Ps), pose_obs=flat("pose_obs", Nsg), lm_obs=flat("lm_obs", Ps * Mp))
    return BAProblem.from_numpy(arrays, device=device)


def alignment_gather(st_t, st_q, st_l, jn_a, jn_ia, jn_b, jn_jb, tie_a, tie_la, tie_b, tie_lb):
    """The alignment step's only cross-segment data: the junction endpoint
    poses and the landmark-tie copies, gathered from the stacked state."""
    return (
        st_t[jn_a, jn_ia], st_q[jn_a, jn_ia],
        st_t[jn_b, jn_jb], st_q[jn_b, jn_jb],
        st_l[tie_a, tie_la], st_l[tie_b, tie_lb],
    )


def _align_segments(st_t, st_q, st_l, info, wt: float, wr: float, tie_w: float = 3.0, iters: int = 3):
    """Level B: per-segment rigid SE(3) corrections from junctions + ties.

    Solves min over xi (n_seg, 6: axis-angle + translation, xi[0] pinned to
    keep the global gauge) of the junction odometry residuals and the
    landmark tie residuals after applying T_k = (R(xi_k), u_k) to everything
    segment k holds: Gauss-Newton on 6*n_seg parameters with a 1e-6 ridge,
    its Jacobian by forward-mode AD (torch.func.jacfwd, the JAX package's
    jax.jacfwd) of this tiny residual. `st_t`, `st_q`, `st_l` are the stacked
    (n_seg, ...) state. Returns xi (n_seg, 6) on the state's device.
    """
    from vision_slam_frontend_tpu_torch.geometry.rotation import (
        axis_angle_to_quat,
        quat_inverse,
        quat_multiply,
        quat_rotate,
        quat_to_axis_angle,
    )

    dev = st_t.device
    n_seg = int(st_t.shape[0])

    def ids(name):
        return torch.as_tensor(info[name], dtype=torch.long, device=dev)

    jn_a, jn_b, tie_a, tie_b = ids("jn_a"), ids("jn_b"), ids("tie_a"), ids("tie_b")
    t_i, q_i, t_j, q_j, l_a, l_b = alignment_gather(
        st_t, st_q, st_l, jn_a, ids("jn_ia"), jn_b, ids("jn_jb"), tie_a, ids("tie_la"), tie_b, ids("tie_lb"))
    t_m = torch.as_tensor(info["jn_t"], dtype=torch.float32, device=dev)
    q_m_inv = quat_inverse(torch.as_tensor(info["jn_q"], dtype=torch.float32, device=dev))
    keep = torch.ones(n_seg, 1, device=dev)
    keep[0] = 0.0  # segment 0 holds the global gauge

    def residual(xi_flat):
        xi = xi_flat.reshape(n_seg, 6) * keep
        q_c = axis_angle_to_quat(xi[:, :3])
        u = xi[:, 3:]

        def corr_t(k, t):
            return quat_rotate(q_c[k], t) + u[k]

        r = []
        if t_i.shape[0]:
            ti2, qi2 = corr_t(jn_a, t_i), quat_multiply(q_c[jn_a], q_i)
            tj2, qj2 = corr_t(jn_b, t_j), quat_multiply(q_c[jn_b], q_j)
            qi_inv = quat_inverse(qi2)
            t_rel = quat_rotate(qi_inv, tj2 - ti2)
            q_err = quat_multiply(q_m_inv, quat_multiply(qi_inv, qj2))
            r.append(((t_rel - t_m) * wt).reshape(-1))
            r.append((quat_to_axis_angle(q_err) * wr).reshape(-1))
        if l_a.shape[0]:
            r.append(((corr_t(tie_a, l_a) - corr_t(tie_b, l_b)) * tie_w).reshape(-1))
        return torch.cat(r) if r else xi_flat.new_zeros(1)

    xi = torch.zeros(6 * n_seg, device=dev)
    ridge = 1e-6 * torch.eye(6 * n_seg, device=dev)
    for _ in range(iters):
        J = torch.func.jacfwd(residual)(xi)
        xi = xi - torch.linalg.solve(J.T @ J + ridge, J.T @ residual(xi))
    return xi.reshape(n_seg, 6) * keep


def _segment_costs(cam, problem: BAProblem, n: int, hd, wt, wr, huber_on: bool):
    """The true cost of each of a folded problem's n segments, (n,)."""
    from vision_slam_frontend_tpu_torch.backend.ba import odometry_cost, reprojection_costs

    obs = reprojection_costs(cam, problem, hd, huber_on).view(n, -1).sum(1)
    return obs + odometry_cost(problem, wt, wr).view(n, -1).sum(1)


def level_a_iteration(cam, folded: BAProblem, pm, plan, lam, n: int, Ps: int, hd, wt, wr, huber_on: bool):
    """One LM iteration of every segment of a folded problem: each segment's
    damped dense Schur step (its own lambda, `lam` (n,)) and the candidate's
    per-segment costs. Returns (candidate, costs (n,))."""
    from vision_slam_frontend_tpu_torch.backend.ba import _apply_step, _dense_core, _linearize_pm

    lin = _linearize_pm(cam, folded, pm, hd, wt, wr, huber_on)
    d_pose, d_lm, _ = _dense_core(pm, *lin, folded, lam, False, plan, Ps)
    cand = _apply_step(folded, d_pose, d_lm)
    return cand, _segment_costs(cam, cand, n, hd, wt, wr, huber_on)


def _correct_and_scatter(problem: BAProblem, st, sq, sl, xi, info) -> BAProblem:
    """Apply each segment's rigid correction to its poses and landmarks (on
    the host, in float64 rounded once) and write the owned copies back into
    the global problem."""
    from vision_slam_frontend_tpu_torch.utils import np_geom

    xi = xi.astype(np.float64)
    R_c = np.stack([np_geom.axis_angle_to_matrix(x) for x in xi[:, :3]])
    q_c = np.stack([np_geom.axis_angle_to_quat(x) for x in xi[:, :3]])
    u_c = xi[:, 3:]
    st = np.einsum("kij,kpj->kpi", R_c, st) + u_c[:, None, :]
    sq = np_geom.quat_multiply_batch(np.broadcast_to(q_c[:, None, :], sq.shape), sq).astype(np.float32)
    sl = np.einsum("kij,klj->kli", R_c, sl) + u_c[:, None, :]
    pt, pq, lm = _np(problem.poses_t).copy(), _np(problem.poses_q).copy(), _np(problem.landmarks).copy()
    own, lown = info["pose_own"], info["lm_own"]
    pt[info["pose_gid"][own]] = st[own]
    pq[info["pose_gid"][own]] = sq[own]
    lm[info["lm_gid"][lown]] = sl[lown]
    dev = problem.device
    return problem.replace(poses_t=torch.from_numpy(pt).to(dev), poses_q=torch.from_numpy(pq).to(dev),
                           landmarks=torch.from_numpy(lm).to(dev))


def optimize_segments(
    problem: BAProblem,
    mesh=None,
    config=None,
    solver=None,
    cam=None,
    n_seg: int | None = None,
    sweeps: int = 2,
    tie_weight: float = 3.0,
    polish_iterations: int = 3,
    verbose: bool = False,
):
    """Segment-parallel LM: all segments advance one iteration per step.

    `mesh` is a shard group (parallel/mesh.make_mesh): the segments split
    over its shards (n_seg must be a multiple of its size), each shard
    running level A on its own; without one every segment runs in this
    process. Each sweep = per-segment LM (level A) + rigid segment alignment
    (level B) + global landmark refit; a sweep is rolled back if it does not
    lower the true global cost, two rejected sweeps in a row end the loop.
    `polish_iterations` matrix-free PCG LM iterations on the JOINT problem
    (observation-sharded over `mesh` when one is given) finish the job.

    Returns (optimized BAProblem, info dict: cost, history, iterations,
    segments, sweeps, max_rejected_in_a_row (the longest run of consecutive
    rejections any segment met in level A) and sweep_seconds (each sweep's
    host time; level A syncs on every iteration's costs)).
    """

    from vision_slam_frontend_tpu_torch.backend.ba import (
        BASolverConfig,
        _build_pm_inputs,
        _dense_coupling_plan,
        _round_f32,
        compute_cost,
        optimize,
        refit_landmarks,
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
    if n_seg is None:
        n_seg = mesh.size if mesh is not None else 4
    if mesh is not None and n_seg % mesh.size:
        raise ValueError(f"n_seg={n_seg} does not split over {mesh.size} shards")

    huber_on = solver.huber_delta > 0
    hd = _round_f32(solver.huber_delta)
    wt = _round_f32(solver.odom_t_weight)
    wr = _round_f32(solver.odom_r_weight)

    def gather(x):
        return x if mesh is None else mesh.gather_rows(x)

    def global_cost(p):
        return float(compute_cost(cam, p, hd, wt, wr, huber_on))

    mine = mesh.local_rows(n_seg) if mesh is not None else slice(0, n_seg)
    n_mine = mine.stop - mine.start
    total_iters = 0
    rejected_sweeps = 0
    longest_rejections = 0
    best_cost = global_cost(problem)
    history = [best_cost]
    sweep_seconds = []
    base = -(-int(problem.num_poses) // n_seg)
    for sweep in range(sweeps):
        t_sweep = time.perf_counter()
        # Alternate the junction locations so boundary poses of one sweep are
        # interior in the next (odd sweeps shift the core edges half a base).
        stacked, info = build_segments(problem, n_seg, offset=0 if sweep % 2 == 0 else base // 2)
        Ps = stacked.poses_t.shape[1]
        folded = fold_segments(stacked, mine, device)
        pm = _build_pm_inputs(folded)
        plan = _dense_coupling_plan(folded, Ps)
        lam = np.full(n_seg, solver.init_lambda, np.float32)
        cost = gather(_segment_costs(cam, folded, n_mine, hd, wt, wr, huber_on)).cpu().numpy()
        streak = np.zeros(n_seg, np.int64)
        for it in range(solver.max_iterations):
            lam_mine = torch.tensor(lam[mine], dtype=torch.float32, device=device)
            cand, new_local = level_a_iteration(cam, folded, pm, plan, lam_mine, n_mine, Ps, hd, wt, wr, huber_on)
            new_cost = gather(new_local).cpu().numpy()
            accept = np.isfinite(new_cost) & (new_cost < cost)
            rows = torch.from_numpy(accept[mine]).to(device)
            keep_p = rows.repeat_interleave(Ps)[:, None]
            keep_l = rows.repeat_interleave(stacked.landmarks.shape[1])[:, None]
            folded = folded.replace(
                poses_t=torch.where(keep_p, cand.poses_t, folded.poses_t),
                poses_q=torch.where(keep_p, cand.poses_q, folded.poses_q),
                landmarks=torch.where(keep_l, cand.landmarks, folded.landmarks),
            )
            # Non-finite = numerically indefinite system: escalate damping
            # fast (cf. backend/ba._optimize_round).
            up = np.where(np.isfinite(new_cost), solver.lambda_up, solver.lambda_up**3)
            lam = np.where(accept, np.maximum(lam * solver.lambda_down, 1e-9), np.minimum(lam * up, 1e6))
            rel = np.where(accept, (cost - new_cost) / np.maximum(cost, 1e-12), 0.0)
            cost = np.where(accept, new_cost, cost)
            streak = np.where(accept, 0, streak + 1)
            longest_rejections = max(longest_rejections, int(streak.max()))
            total_iters += 1
            if verbose:
                print(f"[BA-seg] sweep {sweep} iter {it}: cost {float(cost.sum()):.4f} "
                      f"({int(accept.sum())}/{n_seg} segments accepted)")
            if not accept.any() or float(rel.max()) < 1e-6:
                break

        # --- Level B on the gathered state (replicated on every shard).
        Ls = stacked.landmarks.shape[1]
        state = gather(torch.cat([folded.poses_t.view(n_mine, -1), folded.poses_q.view(n_mine, -1),
                                  folded.landmarks.view(n_mine, -1)], 1))
        st, sq, sl = torch.split(state, [Ps * 3, Ps * 4, Ls * 3], 1)
        st, sq, sl = st.reshape(n_seg, Ps, 3), sq.reshape(n_seg, Ps, 4), sl.reshape(n_seg, Ls, 3)
        xi = _align_segments(st, sq, sl, info, wt, wr, tie_weight)
        candidate = _correct_and_scatter(problem, _np(st), _np(sq), _np(sl), _np(xi), info)
        # Reconcile duplicated landmark copies: global landmark-only GN refit
        # with the swept poses held fixed (separable 3x3 solves).
        candidate = refit_landmarks(cam, candidate, hd, 2, huber_on)
        cand_cost = global_cost(candidate)
        sweep_seconds.append(time.perf_counter() - t_sweep)
        if np.isfinite(cand_cost) and cand_cost < best_cost:
            problem = candidate
            rel_sweep = (best_cost - cand_cost) / max(best_cost, 1e-12)
            best_cost = cand_cost
            history.append(best_cost)
            rejected_sweeps = 0
            if verbose:
                print(f"[BA-seg] sweep {sweep}: global cost -> {best_cost:.4f}")
            if rel_sweep < 1e-6:
                break
        else:
            # Reject the sweep: keep the previous (better) global state. The
            # other offset's decomposition may still make progress; two
            # rejections in a row mean a fixed point.
            history.append(best_cost)
            rejected_sweeps += 1
            if verbose:
                print(f"[BA-seg] sweep {sweep}: rejected (global cost {cand_cost:.4f} >= {best_cost:.4f})")
            if rejected_sweeps >= 2:
                break

    if polish_iterations > 0:
        polish_solver = BASolverConfig(
            max_iterations=polish_iterations,
            schur_solver="pcg",
            cg_iterations=solver.cg_iterations,
            huber_delta=solver.huber_delta,
            odom_t_weight=solver.odom_t_weight,
            odom_r_weight=solver.odom_r_weight,
            fix_first_pose=solver.fix_first_pose,
        )
        if mesh is not None:
            from vision_slam_frontend_tpu_torch.parallel.sharded_ba import pad_observations, shard_ba_problem

            sharded = shard_ba_problem(pad_observations(problem, mesh.size), mesh)
            opt, pinfo = optimize(sharded, cam=cam, solver=polish_solver, verbose=verbose, group=mesh)
        else:
            opt, pinfo = optimize(problem, cam=cam, solver=polish_solver, verbose=verbose)
        if np.isfinite(pinfo["cost"]) and pinfo["cost"] < best_cost:
            problem = problem.replace(poses_t=opt.poses_t, poses_q=opt.poses_q, landmarks=opt.landmarks)
            best_cost = pinfo["cost"]
            history.append(best_cost)
            total_iters += pinfo["iterations"]

    return problem, {
        "cost": best_cost,
        "history": history,
        "iterations": total_iters,
        "segments": n_seg,
        "sweeps": sweeps,
        "max_rejected_in_a_row": longest_rejections,
        "sweep_seconds": sweep_seconds,
    }
