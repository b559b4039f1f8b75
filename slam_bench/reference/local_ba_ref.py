"""Plain reference of the frontend's windowed local BA, as the frontend CLI
drives it one keyframe deep: after keyframe k (k >= 3) the refined poses of
the solve dispatched at keyframe k - 1 are written back, then the last 8
keyframes are solved with the oldest 2 frozen.

A window's problem: tracks are the union-find components of the window's
vision-factor matches (two or more observations), each verified against its
observations' stereo points lifted to world through the keyframe poses
(0.75 m x max(1, depth / 5) from the component-wise median, one observation
per keyframe, the nearest); a landmark starts at its first observation's
lifted point. The solve: observations whose reprojection error at the start
is 80 px or more are dropped, then 6 Levenberg-Marquardt iterations (Huber
5 px as IRLS row weights, odometry weights 30 and 60, lambda from 1e-3,
x 0.4 on an accepted step, x 4 otherwise), each step the Schur complement
solved by 24 iterations of block-Jacobi preconditioned CG from zero, the
landmarks back-substituted (here on the assembled reduced camera matrix,
the program's matrix-free form in exact arithmetic). Every product in
float64 (the control: bfloat16, see ba_ref). Plain PyTorch and NumPy; nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from slam_bench.reference import ba_ref
from slam_bench.reference.frontend_ref import q_normalize

WINDOW = 8
FIXED = 2
HUBER = 5.0
TRIM = 8.0
ITERS = 6
CG_ITERS = 24


def _rot(q):
    w, x, y, z = q_normalize(np.asarray(q, np.float64))
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _tracks(edges: np.ndarray):
    """Connected components of the (pose, feature) match graph: each
    component's members sorted by (pose, feature), components ordered
    longest first, then by first member."""
    ids, inverse = np.unique(edges.reshape(-1, 2), axis=0, return_inverse=True)
    inverse = inverse.reshape(-1, 2)
    n = len(ids)
    graph = csr_matrix((np.ones(len(inverse)), (inverse[:, 0], inverse[:, 1])), shape=(n, n))
    _, label = connected_components(graph, directed=False)
    order = np.lexsort((ids[:, 1], ids[:, 0], label))  # by component, then (pose, feature)
    bounds = np.flatnonzero(np.diff(label[order])) + 1
    comps = [ids[c] for c in np.split(order, bounds)]
    comps = [c for c in comps if len(c) >= 2]
    comps.sort(key=lambda c: (-len(c), tuple(c[0])))
    return comps


def window_arrays(nodes, matches, start: int, cam_R: np.ndarray, cam_t: np.ndarray) -> dict:
    """The window problem of nodes[start:] (local pose rows 0..m-1).
    `nodes[i]` holds loc, angle (the current pose), pixels, right, points;
    `matches[k]` the (past, (q, c) array) factors of keyframe k."""
    m = len(nodes) - start
    edges = [np.stack([np.full(len(qc), past - start), qc[:, 0], np.full(len(qc), k - start), qc[:, 1]], 1)
             for k in range(start, len(nodes)) for past, qc in matches[k] if past >= start and len(qc)]
    comps = _tracks(np.concatenate(edges).astype(np.int64)) if edges else []
    lifted = []
    for i in range(m):
        n = nodes[start + i]
        p3 = n["points"].astype(np.float64)
        ok = np.all(np.isfinite(p3), axis=1) & (p3[:, 2] > 0.05)
        lifted.append(((np.nan_to_num(p3) @ cam_R.T + cam_t) @ _rot(n["angle"]).T + n["loc"].astype(np.float64), ok))
    # Every component's members, flat: component, pose, feature, lifted point.
    lens = np.array([len(c) for c in comps], np.int64)
    cid = np.repeat(np.arange(len(comps)), lens)
    pose, feat = np.concatenate(comps).T if comps else (np.zeros(0, np.int64), np.zeros(0, np.int64))
    offs = np.cumsum([0] + [len(lifted[i][1]) for i in range(m)])
    pts = np.concatenate([lifted[i][0] for i in range(m)])[offs[pose] + feat]
    has = np.concatenate([lifted[i][1] for i in range(m)])[offs[pose] + feat]
    none = len(cid)

    def first_of(members):
        """Each component's first member among `members` (none where it has none)."""
        out = np.full(len(comps), none)
        np.minimum.at(out, cid[members], members)
        return out

    # The component-wise median of the members with a lifted point.
    hi = np.flatnonzero(has)
    n_has = np.bincount(cid[hi], minlength=len(comps))
    lo_i = np.cumsum(n_has) - n_has + (n_has - 1) // 2
    hi_i = np.cumsum(n_has) - n_has + n_has // 2
    med = np.zeros((len(comps), 3))
    some = n_has > 0
    for k in range(3):
        vals = pts[hi[np.lexsort((pts[hi, k], cid[hi]))], k]
        med[some, k] = 0.5 * (vals[lo_i[some]] + vals[hi_i[some]])
    d = np.linalg.norm(pts - med[cid], axis=1)
    f_has = first_of(hi)
    loc = np.stack([n["loc"] for n in nodes[start:]]).astype(np.float64) if m else np.zeros((0, 3))
    depth = np.linalg.norm(med - loc[pose[np.minimum(f_has, max(none - 1, 0))]], axis=1) if none else np.zeros(0)
    thr = 0.75 * np.maximum(1.0, depth / 5.0)
    # One member per (component, pose): the nearest to the median, the first on a tie.
    cand = np.flatnonzero(has & (d <= thr[cid]))
    order = cand[np.lexsort((cand, d[cand], pose[cand], cid[cand]))]
    lead = np.ones(len(order), bool)
    lead[1:] = (cid[order][1:] != cid[order][:-1]) | (pose[order][1:] != pose[order][:-1])
    chosen = np.zeros(none, bool)
    chosen[order[lead]] = True
    n_chosen = np.bincount(cid[chosen], minlength=len(comps))
    whole = n_has < 2  # no geometric evidence either way: kept as it is
    member = np.where(whole[cid], True, chosen & (n_chosen[cid] >= 2))
    kept = np.flatnonzero(whole | (n_chosen >= 2))
    sel = np.flatnonzero(member)
    head = first_of(sel)[kept]
    lm_of = np.full(len(comps), -1)
    lm_of[kept[np.lexsort((feat[head], pose[head]))]] = np.arange(len(kept))
    sel = sel[np.lexsort((sel, lm_of[cid[sel]]))]
    obs_pose, obs_lm = pose[sel], lm_of[cid[sel]]
    px = np.array([nodes[start + a]["pixels"][b] for a, b in zip(obs_pose, feat[sel])], np.float64).reshape(-1, 2)
    pxr = np.array([nodes[start + a]["right"][b] for a, b in zip(obs_pose, feat[sel])], np.float64).reshape(-1, 2)
    has_r = np.all(np.isfinite(pxr), axis=1)
    pxr = np.where(has_r[:, None], pxr, 0.0)
    init = first_of(sel[has[sel]])[kept]
    lms = np.zeros((len(kept), 3))
    lms[lm_of[kept[init < none]]] = pts[init[init < none]]
    f32 = lambda a, shape: np.asarray(a, np.float32).reshape(shape)
    return dict(
        poses_t=f32([nodes[start + i]["loc"] for i in range(m)], (m, 3)),
        poses_q=f32([nodes[start + i]["angle"] for i in range(m)], (m, 4)),
        landmarks=f32(lms, (-1, 3)), obs_pose=np.asarray(obs_pose, np.int64), obs_landmark=np.asarray(obs_lm, np.int64),
        pixel=f32(px, (-1, 2)), pixel_right=f32(pxr, (-1, 2)), has_right=np.asarray(has_r, bool),
        odom=[(i, i + 1) for i in range(m - 1)])


class Window:
    """One window's solve in `dtype` on `device`."""

    def __init__(self, arrays: dict, odometry: list, cam: dict, device, dtype=torch.float64):
        self.dtype = dtype
        self.w = torch.float32 if dtype == torch.bfloat16 else dtype
        t = lambda a: torch.as_tensor(np.asarray(a), device=device).to(dtype)
        self.t0, self.q0, self.lm0 = t(arrays["poses_t"]), t(arrays["poses_q"]), t(arrays["landmarks"])
        self.op = torch.as_tensor(arrays["obs_pose"], device=device)
        self.ol = torch.as_tensor(arrays["obs_landmark"], device=device)
        self.px, self.pxr = t(arrays["pixel"]), t(arrays["pixel_right"])
        self.has_r = t(arrays["has_right"])
        self.mask = torch.ones(self.op.shape[0], dtype=dtype, device=device)
        self.oi = torch.as_tensor([i for i, _ in arrays["odom"]], dtype=torch.long, device=device)
        self.oj = torch.as_tensor([j for _, j in arrays["odom"]], dtype=torch.long, device=device)
        self.ot = t(np.asarray([o[0] for o in odometry], np.float32).reshape(-1, 3))
        self.oq = t(np.asarray([o[1] for o in odometry], np.float32).reshape(-1, 4))
        self.cam = ba_ref.cam_tensors(cam, dtype, device)
        self.P, self.L = self.t0.shape[0], self.lm0.shape[0]
        self.dev = device
        # Every ordered pair of observations of one landmark (observations
        # come grouped by landmark).
        ol = np.asarray(arrays["obs_landmark"], np.int64)
        count = np.bincount(ol, minlength=self.L)
        first = np.cumsum(count) - count
        rep = count[ol]
        a_idx = np.repeat(np.arange(len(ol)), rep)
        b_idx = first[ol[a_idx]] + np.arange(len(a_idx)) - np.repeat(np.cumsum(rep) - rep, rep)
        self.pairs = (torch.as_tensor(a_idx, device=device), torch.as_tensor(b_idx, device=device))

    def _r(self, t, q, lm, jacobians=False):
        out = ba_ref.reprojection(self.cam, t[self.op], q[self.op], lm[self.ol], self.px, self.pxr, self.has_r,
                                  jacobians)
        if not jacobians:
            return out * self.mask[:, None]
        m = self.mask[:, None]
        return out[0] * m, out[1] * m[..., None], out[2] * m[..., None]

    def _ro(self, t, q, jacobians=False):
        args = (t[self.oi], q[self.oi], t[self.oj], q[self.oj], self.ot, self.oq)
        return ba_ref.odometry_lin(*args) if jacobians else ba_ref.odometry(*args)

    def cost(self, t, q, lm):
        n = torch.sqrt((self._r(t, q, lm) ** 2).sum(-1))
        rho = torch.where(n <= HUBER, 0.5 * n * n, HUBER * (n - 0.5 * HUBER)) * self.mask
        ro = self._ro(t, q)
        return (rho.to(self.w).sum() + 0.5 * (ro * ro).to(self.w).sum()).to(torch.float64)

    def step(self, t, q, lm, lam, free):
        P, L, w, dev = self.P, self.L, self.w, self.dev
        r, Jp, Jl = self._r(t, q, lm, jacobians=True)
        n = torch.sqrt((r * r).sum(-1))
        hw = torch.where(n <= HUBER, torch.ones_like(n), torch.sqrt(HUBER / n.clamp(min=1e-12)))
        r, Jp, Jl = (r * hw[:, None]).to(w), (Jp * hw[:, None, None]).to(w), (Jl * hw[:, None, None]).to(w)
        ro, Ji, Jj = (x.to(w) for x in self._ro(t, q, jacobians=True))
        eye3, eye6 = torch.eye(3, dtype=w, device=dev), torch.eye(6, dtype=w, device=dev)
        V = torch.zeros(L, 3, 3, dtype=w, device=dev).index_add_(0, self.ol, Jl.mT @ Jl) + lam * eye3
        Vi = torch.linalg.inv(V)
        g_lm = -torch.zeros(L, 3, dtype=w, device=dev).index_add_(0, self.ol, (Jl.mT @ r[..., None])[..., 0])
        g_p = -torch.zeros(P, 6, dtype=w, device=dev).index_add_(0, self.op, (Jp.mT @ r[..., None])[..., 0])
        g_p.index_add_(0, self.oi, -(Ji.mT @ ro[..., None])[..., 0])
        g_p.index_add_(0, self.oj, -(Jj.mT @ ro[..., None])[..., 0])
        U = torch.zeros(P, 6, 6, dtype=w, device=dev).index_add_(0, self.op, Jp.mT @ Jp)
        U.index_add_(0, self.oi, Ji.mT @ Ji)
        U.index_add_(0, self.oj, Jj.mT @ Jj)
        U = U + lam * eye6
        # The reduced camera matrix S = U + lam I - W V^-1 W^T, assembled once;
        # the step's 24 preconditioned CG iterations then run on it, on the host.
        Wo = Jp.mT @ Jl  # (N, 6, 3)
        Y = Wo @ Vi[self.ol]
        S = torch.zeros(P * P, 6, 6, dtype=w, device=dev)
        idx = torch.arange(P, device=dev)
        S.index_add_(0, idx * P + idx, U)
        S.index_add_(0, self.oi * P + self.oj, Ji.mT @ Jj)
        S.index_add_(0, self.oj * P + self.oi, Jj.mT @ Ji)
        a_idx, b_idx = self.pairs
        S.index_add_(0, self.op[a_idx] * P + self.op[b_idx], -(Y[a_idx] @ Wo[b_idx].mT))
        S2 = S.reshape(P, P, 6, 6).permute(0, 2, 1, 3).reshape(6 * P, 6 * P).cpu().numpy()
        jls = (Y @ g_lm[self.ol][..., None])[..., 0]
        b = (g_p - torch.zeros(P, 6, dtype=w, device=dev).index_add_(0, self.op, jls)).cpu().numpy().reshape(-1)
        Mi = torch.linalg.inv(U).cpu().numpy()
        fr = np.repeat(free.cpu().numpy(), 6).astype(S2.dtype)
        s_apply = lambda v: (S2 @ (v * fr)) * fr
        m_apply = lambda v: (Mi @ v.reshape(P, 6, 1)).reshape(-1) * fr
        x = np.zeros_like(b)
        rr = b * fr
        zz = m_apply(rr)
        p, rz = zz, (rr * zz).sum()
        for _ in range(CG_ITERS):
            sp = s_apply(p)
            den = (p * sp).sum()
            alpha = rz / den if abs(den) > 1e-20 else 0.0
            x = x + alpha * p
            rr2 = rr - alpha * sp
            z2 = m_apply(rr2)
            rz2 = (rr2 * z2).sum()
            beta = rz2 / rz if abs(rz) > 1e-20 else 0.0
            p = z2 + beta * p
            rr, rz = rr2, rz2
        x = torch.as_tensor(x.reshape(P, 6), device=dev)
        yv = (Jp @ x[self.op][..., None])[..., 0]
        wtd = torch.zeros(L, 3, dtype=w, device=dev).index_add_(0, self.ol, (Jl.mT @ yv[..., None])[..., 0])
        return x, (Vi @ (g_lm - wtd)[..., None])[..., 0]

    def solve(self, n_fixed: int):
        """The window's refined poses (P, 3) and (P, 4)."""
        t, q, lm = self.t0, self.q0, self.lm0
        self.mask = self.mask * (torch.sqrt((self._r(t, q, lm) ** 2).sum(-1)) < 10.0 * TRIM).to(self.dtype)
        free = torch.arange(self.P, device=self.dev) >= n_fixed
        cost = self.cost(t, q, lm)
        lam = 1e-3
        for _ in range(ITERS):
            dp, dl = self.step(t, q, lm, lam, free)
            dp, dl = dp.to(self.dtype), dl.to(self.dtype)
            ct = t + dp[:, :3]
            cq = ba_ref.q_norm(ba_ref.q_mul(q, ba_ref.q_exp(dp[:, 3:])))
            cl = lm + dl
            nc = self.cost(ct, cq, cl)
            if torch.isfinite(nc) and nc < cost:
                t, q, lm, cost = ct, cq, cl, nc
                lam = max(lam * 0.4, 1e-9)
            else:
                lam = min(lam * 4.0, 1e6)
        return t.to(torch.float64).cpu().numpy(), q.to(torch.float64).cpu().numpy()


def camera(calib: dict) -> dict:
    """The solver's camera from the frontend calib dict, float32-rounded."""
    f = lambda v: float(np.float32(v))
    il, ir = calib["intrinsics_left"], calib["intrinsics_right"]
    A = np.asarray(calib["right_extrinsic"], np.float32).astype(np.float64)
    return dict(fx=f(il["fx"]), fy=f(il["fy"]), cx=f(il["cx"]), cy=f(il["cy"]),
                fx_r=f(ir["fx"]), fy_r=f(ir["fy"]), cx_r=f(ir["cx"]), cy_r=f(ir["cy"]),
                R_cr=np.asarray(calib["left_cam_to_robot_rotation"], np.float32).astype(np.float64),
                t_cr=np.asarray(calib["left_cam_to_robot_translation"], np.float32).astype(np.float64),
                R_rl=A[:, :3], t_rl=A[:, 3])


def run(nodes, matches, odometry, calib: dict, device, dtype=torch.float64, window: int = WINDOW):
    """Every node's pose after the pipelined local BA, in node order.
    `odometry[k]` is the (translation, rotation) factor from keyframe k - 1
    to k. Nodes' loc and angle are updated in place."""
    cam = camera(calib)
    cam_R, cam_t = cam["R_cr"], cam["t_cr"]
    in_flight = None
    for k in range(len(nodes)):
        if k + 1 < 4:
            continue
        if in_flight is not None:
            _apply(nodes, *in_flight)
            in_flight = None
        n = k + 1
        start = max(0, n - window)
        arrays = window_arrays(nodes[:n], matches, start, cam_R, cam_t)
        if not len(arrays["obs_pose"]) and not any(p >= start for kk in range(start, n) for p, _ in matches[kk]):
            continue
        m = n - start
        k0 = min(FIXED, m)
        odo = [odometry[start + i + 1] for i in range(m - 1)]
        t, q = Window(arrays, odo, cam, device, dtype).solve(k0)
        in_flight = (start, k0, t, q)
    if in_flight is not None:
        _apply(nodes, *in_flight)
    return nodes


def _apply(nodes, start, k0, t, q):
    for i in range(k0, t.shape[0]):
        nodes[start + i]["loc"] = t[i].astype(np.float32)
        nodes[start + i]["angle"] = q[i].astype(np.float32)
