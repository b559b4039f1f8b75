"""Offline bundle adjustment, slam_backend's path: the port's
backend.ba.optimize, solve after solve on the same problem, with
BASolverConfig's defaults updated by the traffic file's `solver` object
(for example {"schur_solver": "pcg"}). Each solve starts from the problem on
the device and ends with the solution on the host; ba_solve_s is the window
over the solves it completed. After the window, every solve is held against
one float64 reference solve."""

from __future__ import annotations

import gc
import threading
import time

import numpy as np

from slam_bench import ba_problem, devtrace
from slam_bench.common import Refused, Spans
from slam_bench.reference import ba_ref

# The solver settings a traffic file may change: how each LM step is solved
# and how many are taken, which the reference follows; the rest change the
# problem the reference solves.
SOLVER_KEYS = ("schur_solver", "dense_max_poses", "dense_chunked_max_poses", "chunked_obs_threshold",
               "cg_iterations", "cg_tol", "max_iterations")


def _program_problem(arrays: dict, cam: dict, device):
    import torch

    from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams
    from vision_slam_frontend_tpu_torch.backend.tracks import build_gather_tables
    from vision_slam_frontend_tpu_torch.types.slam_types import BAProblem

    a = dict(arrays)
    P, L = a["poses_t"].shape[0], a["landmarks"].shape[0]
    po, pom, lo, lom = build_gather_tables(a["obs_pose"], a["obs_landmark"], a["obs_mask"], P, L)
    a.update(pose_obs=po, pose_obs_mask=pom, lm_obs=lo, lm_obs_mask=lom)
    camera = CameraParams(fx=cam["fx"], fy=cam["fy"], cx=cam["cx"], cy=cam["cy"], R_cr=np.eye(3), t_cr=np.zeros(3),
                          fx_r=cam["fx_r"], fy_r=cam["fy_r"], cx_r=cam["cx_r"], cy_r=cam["cy_r"],
                          R_rl=np.eye(3), t_rl=[-cam["baseline"], 0.0, 0.0])
    return BAProblem.from_numpy(a, device=device), camera.to(torch.device(device))


def run(cell: dict, seed: int, seconds: float, trace: bool, t_process0: float, device: str = "cuda") -> dict:
    import torch

    from vision_slam_frontend_tpu_torch.backend.ba import BASolverConfig, optimize

    config, traffic = cell["config"], cell["traffic"]
    on_card = device == "cuda"
    cam = ba_problem.camera(config)
    t0 = time.perf_counter()
    prob = ba_problem.make(config, traffic, seed, device)
    arrays = ba_problem.program_arrays(prob)
    t_made = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    problem, camera = _program_problem(arrays, cam, device)

    spans = Spans(trace)
    settings = traffic.get("solver", {})
    if set(settings) - set(SOLVER_KEYS):
        raise Refused(f"the reference does not follow solver settings {sorted(set(settings) - set(SOLVER_KEYS))}")
    solver = BASolverConfig(**settings)

    def one():
        with spans.span("ba.optimize"):
            out, info = optimize(problem, solver=solver, cam=camera)
        with spans.span("ba.fetch"):
            host = (out.poses_t.cpu().numpy(), out.poses_q.cpu().numpy(), out.landmarks.cpu().numpy())
        return host, info

    one()  # warm-up: the allocator, cuBLAS and cuSOLVER handles
    if on_card:
        torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    t_start = time.perf_counter()
    answers, iters, solve_s = [], [], []
    while True:
        a = time.perf_counter()
        host, info = one()
        solve_s.append(time.perf_counter() - a)
        answers.append((host, info["cost"]))
        iters.append(info["iterations"])
        if time.perf_counter() - t_start >= seconds:
            break
    t_end = time.perf_counter()
    rec, slice_iters = None, 0
    if trace and on_card:
        s = devtrace.Slice()
        _, info = one()
        rec = s.close()
        slice_iters = info["iterations"]
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    del problem
    if on_card:
        torch.cuda.empty_cache()

    # --- the reference, once, and every answer against it.
    t_ref = time.perf_counter()
    ref_in = dict(prob, poses_t=arrays["poses_t"], poses_q=arrays["poses_q"], landmarks=arrays["landmarks"],
                  pixel=prob["pixel"].astype(np.float32), pixel_right=prob["pixel_right"].astype(np.float32),
                  odom_t=arrays["odom_t"], odom_q=arrays["odom_q"])
    ref = ba_ref.Problem(ref_in, cam, device)
    rt, rq, rl, rcost, rit = ba_ref.solve(ref, solver.max_iterations)
    numbers = dict(cost_gap=0.0, reported_cost_gap=0.0, pose_gap_m=0.0, landmark_gap_m=0.0)
    evaluated = {}
    for (t, q, lm), reported in answers:
        key = (t.tobytes(), q.tobytes(), lm.tobytes())
        if key not in evaluated:
            dt = lambda x: torch.as_tensor(x, device=device).to(torch.float64)
            c = ref.cost(dt(t), dt(q), dt(lm))
            evaluated[key] = (c, float(np.abs(t - rt.cpu().numpy()).max()),
                              float(np.percentile(np.linalg.norm(lm - rl.cpu().numpy(), axis=-1), 99)))
        c, pg, lg = evaluated[key]
        numbers["cost_gap"] = max(numbers["cost_gap"], abs(c - rcost) / rcost)
        numbers["reported_cost_gap"] = max(numbers["reported_cost_gap"], abs(reported - c) / c)
        numbers["pose_gap_m"] = max(numbers["pose_gap_m"], pg)
        numbers["landmark_gap_m"] = max(numbers["landmark_gap_m"], lg)
    ref_s = time.perf_counter() - t_ref
    window_s = t_end - t_start
    n_obs = int(arrays["obs_mask"].sum())
    notes = [
        f"ba_solve_s over {len(answers)} solves in {window_s:.3f} s; LM iterations per solve {sorted(set(iters))}",
        f"problem: P={arrays['poses_t'].shape[0]}, L={arrays['landmarks'].shape[0]}, {n_obs} stereo observations; "
        f"made in {t_made:.2f} s",
        f"reference: cost {rcost:.6g} after {rit} iterations in {ref_s:.2f} s; {len(evaluated)} distinct answers",
    ]
    ctx = dict(kind="ba", slice=rec, slice_iters=slice_iters, window_s=window_s,
               iterations=sum(iters), solve_s=solve_s, spans=spans, main_thread=threading.get_ident())
    return dict(e2e={"ba_solve_s": window_s / len(answers), "setup_s": t_start - t_process0}, numbers=numbers,
                attempted=len(answers), failed=0, peak=peak, ctx=ctx, notes=notes)
