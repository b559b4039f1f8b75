"""Windowed local bundle adjustment (port of backend/local_ba.py): refine the
trailing keyframes online.

As keyframes stream in, the last `window` poses and their landmarks are
optimized against vision and odometry factors while older poses stay
frozen: the local-BA stage of an online visual-SLAM system (the frontend
CLI's `--local_ba N`).

The solve is one fixed sequence of device work per keyframe with no host
sync: a pre-trim, then `iters` LM iterations of the scatter-form Schur PCG
whose accept/reject and damping are selected on the device. With
`pipeline=True` the result comes back through a pinned host buffer and a
CUDA event, and is applied at the caller's next call (or `flush`), so the
device solve overlaps the caller's next frame. The in-flight solve and the
camera are held by a `LocalBAState` that the caller owns, one per session:
nothing lives in module globals.

On CUDA with a state, each capacity bucket of _pad_ba_for_device keeps the
solve's static inputs (`_SolveGraph`) and its CUDA graph, made by
utils/cuda_graph.CapturedCall (layer `local_ba`): the bucket's first window
runs eagerly, its second is captured, and every later one is one replay, so
a window's ~22,000 launches become one cudaGraphLaunch with the same kernels
in the same order.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from vision_slam_frontend_tpu_torch.backend.ba import (
    BASolverConfig,
    _apply_step,
    _linearize,
    _reproj_residual_norms,
    _solve_schur_pcg_scatter,
    compute_cost,
    optimize,
)
from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams
from vision_slam_frontend_tpu_torch.backend.tracks import build_ba_arrays, build_ba_problem
from vision_slam_frontend_tpu_torch.types.slam_types import (
    BAProblem,
    OdometryFactor,
    SLAMNode,
    SLAMProblem,
    VisionFactor,
    _field_dtype,
)
from vision_slam_frontend_tpu_torch.utils.cuda_graph import CapturedCall
from vision_slam_frontend_tpu_torch.utils.device import resolve_device
from vision_slam_frontend_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class LocalSolveSettings:
    """The local solve's settings: the literals of the JAX package's
    production call site (its windowed_local_ba), kept as they are. The
    Huber delta is 5.0 px, not BASolverConfig.huber_delta (4.0): the
    reference's local solve has its own, and the parity tests pin it. As in
    the JAX package, no CLI flag or config field sets these."""

    huber_delta: float = 5.0
    odom_t_weight: float = 30.0
    odom_r_weight: float = 60.0
    trim: float = 8.0
    iters: int = 6
    cg_iters: int = 24


SOLVE = LocalSolveSettings()


def slice_problem(problem: SLAMProblem, start: int) -> SLAMProblem:
    """Sub-problem over nodes with node_idx >= start, re-indexed from 0.
    Factors touching earlier nodes are dropped (their constraints enter via
    the frozen-pose gauge of the retained overlap)."""
    out = SLAMProblem()
    for node in problem.nodes:
        if node.node_idx >= start:
            out.nodes.append(SLAMNode(node.node_idx - start, node.timestamp, node.pose, node.features))
    for vf in problem.vision_factors:
        if vf.pose_idx_initial >= start and vf.pose_idx_current >= start:
            out.vision_factors.append(
                VisionFactor(vf.pose_idx_initial - start, vf.pose_idx_current - start, vf.feature_matches)
            )
    for of in problem.odometry_factors:
        if of.pose_i >= start and of.pose_j >= start:
            out.odometry_factors.append(
                OdometryFactor(of.pose_i - start, of.pose_j - start, of.translation, of.rotation)
            )
    return out


def _pad_up(n: int, mult: int) -> int:
    return max(mult, -(-n // mult) * mult)


def _pad_ba_for_device(ba: dict, n_poses: int, lm_mult: int = 512, obs_mult: int = 2048, odom_cap: int = 32) -> dict:
    """Pad a BA problem's numpy arrays to bucketed capacities: poses to
    `n_poses`, landmarks and observations to multiples of `lm_mult` and
    `obs_mult`, odometry to `odom_cap`, so a session meets a handful of
    shapes (one CUDA graph each, `_SolveGraph`). Padded poses are masked and frozen
    with identity quaternions (no factor touches them); padded landmarks,
    observations and odometry are masked out. The gather tables are dropped:
    the device solve takes the scatter form."""
    P0 = ba["poses_t"].shape[0]
    L0 = ba["landmarks"].shape[0]
    N0 = ba["obs_pose"].shape[0]
    Q0 = ba["odom_i"].shape[0]
    P = max(n_poses, P0)
    L = _pad_up(L0, lm_mult)
    N = _pad_up(N0, obs_mult)
    Q = max(odom_cap, Q0)

    def padn(a, n, fill=0):
        pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
        return np.pad(np.asarray(a), pad, constant_values=fill)

    fixed = ba.get("pose_fixed")
    fixed = padn(np.asarray(fixed, bool) if fixed is not None else np.zeros(P0, bool), P, fill=True)
    q_pad = padn(ba["poses_q"], P)
    q_pad[P0:, 0] = 1.0  # identity quaternions on padded poses
    oq_pad = padn(ba["odom_q"], Q)
    oq_pad[Q0:, 0] = 1.0
    out = dict(
        poses_t=padn(ba["poses_t"], P),
        poses_q=q_pad,
        pose_mask=padn(ba["pose_mask"], P),
        pose_fixed=fixed,
        landmarks=padn(ba["landmarks"], L),
        landmark_mask=padn(ba["landmark_mask"], L),
        obs_pose=padn(ba["obs_pose"], N),
        obs_landmark=padn(ba["obs_landmark"], N),
        obs_pixel=padn(ba["obs_pixel"], N),
        obs_mask=padn(ba["obs_mask"], N),
        odom_i=padn(ba["odom_i"], Q),
        odom_j=padn(ba["odom_j"], Q),
        odom_t=padn(ba["odom_t"], Q),
        odom_q=oq_pad,
        odom_mask=padn(ba["odom_mask"], Q),
    )
    if ba.get("obs_pixel_right") is not None:
        out["obs_pixel_right"] = padn(ba["obs_pixel_right"], N)
        out["obs_right_mask"] = padn(ba["obs_right_mask"], N)
    return out


def _device_lm_solve(cam: CameraParams, prob: BAProblem, hd, wt, wr, trim, iters: int, cg_iters: int):
    """The whole windowed LM solve as a fixed sequence of device work, with
    no host sync: a pre-trim of gross outliers at the initial estimate (the
    loose 10x gate of optimize's trimming), then `iters` iterations of
    linearize -> scatter Schur-PCG -> candidate cost, the candidate accepted
    or rejected and the damping raised or lowered by torch.where on the
    device. Returns (poses_t, poses_q, initial cost, final cost, (iters,)
    bool: each iteration's step accepted), tensors."""
    norms = _reproj_residual_norms(cam, prob)
    prob = prob.replace(obs_mask=prob.obs_mask & (norms < 10.0 * trim))
    cost0 = compute_cost(cam, prob, hd, wt, wr, True)
    pt, pq, lm, cost = prob.poses_t, prob.poses_q, prob.landmarks, cost0
    # A fill, not a copy from the host: a host scalar copied into a CUDA
    # tensor synchronizes.
    lam = torch.full((), 1e-3, dtype=torch.float32, device=prob.device)
    accepted = []
    for _ in range(iters):
        p = prob.replace(poses_t=pt, poses_q=pq, landmarks=lm)
        r, Jp, Jl, ro, Ji, Jj = _linearize(cam, p, hd, wt, wr, True)
        dp, dl, _ = _solve_schur_pcg_scatter(r, Jp, Jl, ro, Ji, Jj, p, lam, cg_iters, False)
        cand = _apply_step(p, dp, dl)
        nc = compute_cost(cam, cand, hd, wt, wr, True)
        ok = torch.isfinite(nc) & (nc < cost)
        pt = torch.where(ok, cand.poses_t, pt)
        pq = torch.where(ok, cand.poses_q, pq)
        lm = torch.where(ok, cand.landmarks, lm)
        lam = torch.where(ok, (lam * 0.4).clamp(min=1e-9), (lam * 4.0).clamp(max=1e6))
        cost = torch.where(ok, nc, cost)
        accepted.append(ok)
    return pt, pq, cost0, cost, torch.stack(accepted)


def _solve_window(cam: CameraParams, prob: BAProblem, settings: LocalSolveSettings = SOLVE):
    """The device solve at `settings`, its result packed into one float32
    vector [poses_t | poses_q | cost0 | cost | accepted (iters)] for a single
    fetch."""
    s = settings
    pt, pq, cost0, cost, accepted = _device_lm_solve(
        cam, prob, s.huber_delta, s.odom_t_weight, s.odom_r_weight, s.trim, s.iters, s.cg_iters,
    )
    return torch.cat([pt.reshape(-1), pq.reshape(-1), cost0.reshape(1), cost.reshape(1), accepted.float()])


def window_arrays(sub: SLAMProblem, config, window: int, n_fixed: int) -> dict:
    """The device solve's input for a window sub-problem (slice_problem's)
    in numpy: its tracks without gather tables, the first `n_fixed` poses
    frozen, padded to the buckets of _pad_ba_for_device."""
    arrays = build_ba_arrays(sub, left_cam_to_robot=config.left_cam_to_robot, gather_tables=False)
    fixed = np.zeros(arrays["poses_t"].shape[0], bool)
    fixed[:n_fixed] = True
    arrays["pose_fixed"] = fixed
    return _pad_ba_for_device(arrays, n_poses=window)


def window_problem(sub: SLAMProblem, config, window: int, n_fixed: int, device) -> BAProblem:
    """window_arrays uploaded to `device` in one non-blocking pass."""
    return BAProblem.from_numpy(window_arrays(sub, config, window, n_fixed), device=device)


def _bucket_key(padded: dict, device) -> tuple:
    """A padded window's capacity bucket: (P, L, N, Q, whether it has right
    observations, device)."""
    return (padded["poses_t"].shape[0], padded["landmarks"].shape[0], padded["obs_pose"].shape[0],
            padded["odom_i"].shape[0], "obs_pixel_right" in padded, torch.device(device))


# Each static input starts on the caching allocator's block boundary, where
# a tensor of its own would: the kernels see the alignment the eager solve sees.
_ALIGN = 512


class _SolveGraph:
    """One capacity bucket's solve as a CUDA graph. Its static inputs are
    the bucket's BAProblem fields as views of one device buffer, written by
    one copy from a pinned staging buffer of the same layout; its static
    output is _solve_window's packed vector."""

    def __init__(self, padded: dict, device):
        device = torch.device(device)
        cuda = device.type == "cuda"
        layout, size = [], 0
        for f in dataclasses.fields(BAProblem):
            a = padded.get(f.name)
            if a is None:
                continue
            a = np.asarray(a)
            dtype = torch.from_numpy(np.empty(0, _field_dtype(f.name, a.dtype))).dtype
            nbytes = a.size * dtype.itemsize
            layout.append((f.name, size, nbytes, dtype, a.shape))
            size += -(-nbytes // _ALIGN) * _ALIGN
        self.staging = torch.empty(size, dtype=torch.uint8, pin_memory=cuda)
        self.buffer = torch.empty(size, dtype=torch.uint8, device=device) if cuda else self.staging

        def views(buf):
            return {name: buf[o : o + n].view(dt).view(shape) for name, o, n, dt, shape in layout}

        self.host = {name: t.numpy() for name, t in views(self.staging).items()}
        self.problem = BAProblem(**views(self.buffer))
        self.uploaded = None  # the CUDA event after the last copy out of the staging buffer
        self.call = CapturedCall("local_ba")

    def upload(self, padded: dict) -> BAProblem:
        """A window of this bucket written into the static inputs: each
        array cast into its slot of the staging buffer, once the copy that
        last read the buffer has completed, then one non-blocking copy."""
        if self.uploaded is not None:
            self.uploaded.synchronize()
        for name, slot in self.host.items():
            np.copyto(slot, padded[name], casting="unsafe")
        if self.buffer is not self.staging:
            self.buffer.copy_(self.staging, non_blocking=True)
            self.uploaded = torch.cuda.Event()
            self.uploaded.record()
        return self.problem

    def run(self, cam: CameraParams, request) -> torch.Tensor:
        """_solve_window on the static inputs; from the bucket's second
        window on, the graph's static output, rewritten by the next replay."""
        return self.call(lambda: _solve_window(cam, self.problem), request)


class _InFlight(NamedTuple):
    """A dispatched solve: the window's nodes (references into the caller's
    problem), the first node it updates, the padded pose capacity, the host
    buffer the result lands in, and the CUDA event that marks it landed
    (None on the CPU)."""

    nodes: list
    k0: int
    P: int
    host: torch.Tensor
    event: Optional[torch.cuda.Event]


def _fetch(packed: torch.Tensor):
    """(host buffer, event): on CUDA an asynchronous copy into pinned memory
    and the event recorded after it; on the CPU the tensor itself."""
    if not packed.is_cuda:
        return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _apply(solve: _InFlight):
    """Wait for the solve's result and write its poses into the window's
    nodes. Returns (updated, info)."""
    if solve.event is not None:
        with span("local_ba.apply.wait"):
            solve.event.synchronize()
    out = solve.host.numpy()
    P = solve.P
    new_t = out[: P * 3].reshape(P, 3)
    new_q = out[P * 3 : P * 7].reshape(P, 4)
    cost0, cost = float(out[P * 7]), float(out[P * 7 + 1])
    for k in range(solve.k0, len(solve.nodes)):
        solve.nodes[k].pose.loc = new_t[k].astype(np.float32)
        solve.nodes[k].pose.angle = new_q[k].astype(np.float32)
    info = {"cost": cost, "history": [cost0, cost], "node_idx": solve.nodes[-1].node_idx,
            "accepted": [bool(a) for a in out[P * 7 + 2 :] > 0.5]}
    return len(solve.nodes) - solve.k0, info


class LocalBAState:
    """What one session's local BA keeps between keyframes: a single camera
    slot, the in-flight pipelined solve and, on CUDA, one solve graph per
    capacity bucket. The caller owns it (one per Frontend); two states in
    one process never see each other's solves or graphs."""

    def __init__(self):
        self._camera = None  # (config, device, CameraParams)
        self._in_flight: Optional[_InFlight] = None
        self._graphs: dict[tuple, _SolveGraph] = {}  # by _bucket_key

    def camera(self, config, device) -> CameraParams:
        """The config's CameraParams on `device`, uploaded once per session.
        A new camera drops the graphs, which read the one they were captured
        with."""
        device = torch.device(device)
        slot = self._camera
        if slot is None or slot[0] is not config or slot[1] != device:
            self._graphs.clear()
            self._camera = slot = (config, device, CameraParams.from_config(config, device=device))
        return slot[2]

    def graph(self, padded: dict, device) -> _SolveGraph:
        """The solve graph of a padded window's bucket, made at the bucket's
        first window."""
        key = _bucket_key(padded, device)
        if key not in self._graphs:
            self._graphs[key] = _SolveGraph(padded, device)
        return self._graphs[key]

    @property
    def in_flight(self) -> bool:
        return self._in_flight is not None

    def flush(self):
        """Apply the in-flight solve (waiting for it if it has not landed).
        Returns (updated, info): info has the window's cost history,
        `node_idx`, the newest node of the flushed window, and `accepted`,
        each LM iteration's decision; (0, None) when nothing is in flight."""
        solve, self._in_flight = self._in_flight, None
        if solve is None:
            return 0, None
        with span("local_ba.apply", solve.nodes[-1].node_idx):
            return _apply(solve)


def _host_loop_window(problem: SLAMProblem, config, start: int, fixed_overlap: int, solver: BASolverConfig,
                      device):
    """The window from node `start` solved by the host-loop optimize(): the
    full BASolverConfig surface (multi-round trimming, validation,
    checkpointing) at the host loop's sync cost. Writes the refined poses
    into `problem`; returns (updated, info), or None when the window has no
    vision factors."""
    sub = slice_problem(problem, start)
    if len(sub.vision_factors) == 0:
        return None
    device = resolve_device(device)
    m = len(sub.nodes)
    k0 = min(fixed_overlap, m)
    ba = build_ba_problem(sub, left_cam_to_robot=config.left_cam_to_robot, device=device)
    fixed = torch.arange(ba.num_poses, device=device) < k0
    opt, info = optimize(ba.replace(pose_fixed=fixed), config=config, solver=solver)
    new_t, new_q = opt.poses_t.cpu().numpy(), opt.poses_q.cpu().numpy()
    for k in range(k0, m):
        node = problem.nodes[start + k]
        node.pose.loc = new_t[k].astype(np.float32)
        node.pose.angle = new_q[k].astype(np.float32)
    return m - k0, info


def windowed_local_ba(
    problem: SLAMProblem,
    config,
    window: int = 8,
    fixed_overlap: int = 2,
    solver: Optional[BASolverConfig] = None,
    pipeline: bool = False,
    state: Optional[LocalBAState] = None,
    device="cuda",
):
    """Optimize the last `window` poses; the oldest `fixed_overlap` of them
    stay frozen as the anchor to the rest of the trajectory.

    Runs the device solve (_device_lm_solve) on `device` (default cuda;
    raises where there is no GPU) over bucketed capacities; on CUDA with a
    `state`, as the bucket's CUDA graph (`_SolveGraph`). Mutates
    `problem` in place (updates the tail nodes' poses). Returns
    (updated_tail_count, info); info is None when the window is too small to
    optimize. An explicit `solver` runs the host-loop optimize() instead
    (its full trimming and validation surface).

    With `pipeline=True` (the CLI's streaming loop) the solve is dispatched
    without waiting and applied at the next call on the same `state` (or at
    `state.flush()`): the same math, since the pending result lands before
    the next window is built, but the solve and its fetch overlap the
    caller's next frame. The returned (updated, info) then describe the
    PREVIOUS keyframe's flushed solve. `state` holds the camera and the
    in-flight solve; it is required with `pipeline`.
    """
    if pipeline and state is None:
        raise ValueError("windowed_local_ba(pipeline=True) needs the caller's LocalBAState")
    flushed = state.flush() if pipeline else None

    n = len(problem.nodes)
    if n < fixed_overlap + 2:
        return flushed if pipeline else (0, None)
    start = max(0, n - window)
    if solver is not None:
        out = _host_loop_window(problem, config, start, fixed_overlap, solver, device)
        if out is None:
            return flushed if pipeline else (0, None)
        return out

    request = problem.nodes[-1].node_idx  # the keyframe this window's solve is dispatched at
    with span("local_ba.build", request):
        sub = slice_problem(problem, start)
        if len(sub.vision_factors) == 0:
            return flushed if pipeline else (0, None)
        device = resolve_device(device)
        m = len(sub.nodes)
        k0 = min(fixed_overlap, m)
        padded = window_arrays(sub, config, window, k0)
        cam = (state or LocalBAState()).camera(config, device)
        graph = state.graph(padded, device) if state is not None and device.type == "cuda" else None
        prob = BAProblem.from_numpy(padded, device=device) if graph is None else graph.upload(padded)
    with span("local_ba.dispatch", request):
        host, event = _fetch(_solve_window(cam, prob) if graph is None else graph.run(cam, request))
    solve = _InFlight([problem.nodes[start + k] for k in range(m)], k0, prob.num_poses, host, event)
    if pipeline:
        state._in_flight = solve
        return flushed
    return _apply(solve)
