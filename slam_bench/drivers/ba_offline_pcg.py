"""Offline bundle adjustment on the port's pose-major PCG route: ba_offline's
run (backend.ba.optimize solve after solve on one problem, BASolverConfig's
defaults updated by the traffic's `solver`, ba_solve_s over the window, one
profiled solve after it) held to slam_bench/reference/ba_pcg_ref, the
reference of that route's own step, twice: ba_offline's four numbers against
the reference's exact step (`cost_gap`, `reported_cost_gap`, `pose_gap_m`,
`landmark_gap_m`: what the route's truncated CG costs), and three against the
reference taking the route's own `cg_iterations` of PCG (`route_cost_gap`,
`route_pose_gap_m`, `route_landmark_gap_m`: whether the program computes
that step). Both references take the CG and LM iteration counts that the
configuration states (`cg_iterations`, `max_iterations`), never the
program's defaults, so that a program taking fewer reads not correct. The
run is refused where the configuration states no such count, where the
traffic's `solver` sets one against it, where the settings select another
route, and on the CPU at a size meant for the card.

A traced run profiles two solves after the window. The first is
devtrace's slice (CUDA activity only, as ba_offline's), for the readers
that the dense route's cell shares. The second (`PcgSlice`,
ctx["pcg_slice"]) records CPU activity too, so that its trace holds the
program's spans (the host side of record_function, which each span enters;
a CUDA-only trace holds none) on the same clock as the launch calls, and
keeps the launch calls, each kernel's launch call (`kernel_launches`:
launch start, kernel duration) and the spans' ranges by name
(`annotations`). The readers of the PCG loop match launches to spans there,
with no map from the host's clock onto the trace's. Both slices pad their
edges with kernels of their own (`pad`), where the profiler loses records. The second solve is
left out where the program records no counters: it then has no `ba.pcg`
span either. ctx["pcg"] holds the problem's shapes for
slam_bench/roofline_pcg."""

from __future__ import annotations

import gc
import json
import os
import tempfile
import threading
import time

import numpy as np

from slam_bench import ba_problem, devtrace
from slam_bench.common import Refused, Spans
from slam_bench.drivers.ba_offline import SOLVER_KEYS, _program_problem
from slam_bench.reference import ba_pcg_ref

# A CPU run is a test: past this many observations the cell is the card's.
CPU_MAX_OBSERVATIONS = 200_000
# What the configuration states of the solve, and the references follow.
STATED = ("cg_iterations", "max_iterations")


# The profiler loses kernel records at a session's edges (H100, torch 2.11,
# CUDA 12.8): in a process that has profiled a large session before, the
# first one or two kernels of each later session, and up to a few thousand
# of the last kernels of a large one, whose records are still on their way
# when the profiler stops (an idle 0.5 s before the stop keeps them). A slice
# that loses a marker gives no record at all. So each slice opens with
# HEAD_PAD one-element kernels and closes with TAIL_PAD of them and an idle
# TAIL_WAIT_S, and what is lost lies outside the slice.
HEAD_PAD, TAIL_PAD, TAIL_WAIT_S = 100, 10_000, 0.25


def pad(n: int):
    """n one-element kernels, then a sync."""
    import torch

    x = torch.zeros(1, device="cuda")
    for _ in range(n):
        x.add_(1.0)
    torch.cuda.synchronize()


class Slice(devtrace.Slice):
    """devtrace's slice (CUDA activity only, a spin-kernel marker at each
    end, read by devtrace.read_events into the same record), with padding
    between each marker and the profiler's start or stop."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        pad(HEAD_PAD)
        self.host0 = time.perf_counter()
        torch.cuda._sleep(1000)
        self.host1 = None

    def close(self):
        import torch

        torch.cuda.synchronize()
        self.host1 = time.perf_counter()
        torch.cuda._sleep(1000)
        pad(TAIL_PAD)
        time.sleep(TAIL_WAIT_S)
        self.prof.__exit__(None, None, None)
        events = trace_events(self.prof)
        self.prof = None
        return devtrace.read_events(events, self.host0, self.host1)


def trace_events(prof) -> list:
    """The finished profiler's Chrome-trace events."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


class PcgSlice:
    """One solve under torch.profiler with CPU and CUDA activity. The trace
    holds that solve and the padding alone, and the readers take only what
    lies inside the program's spans, so the record needs no markers: {host0, host1
    (host clock, for the program's counters), launches [start s] (the
    kernel-launch calls, as devtrace counts them), kernel_launches,
    annotations}, all on the trace's clock."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        pad(HEAD_PAD)
        self.host0 = time.perf_counter()

    def close(self) -> dict:
        import torch

        torch.cuda.synchronize()
        host1 = time.perf_counter()
        pad(TAIL_PAD)
        time.sleep(TAIL_WAIT_S)
        self.prof.__exit__(None, None, None)
        events = trace_events(self.prof)
        self.prof = None
        launches = sorted(float(e["ts"]) / 1e6 for e in events if e.get("ph") == "X"
                          and e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", ""))
        return dict(host0=self.host0, host1=host1, launches=launches, kernel_launches=kernel_launches(events),
                    annotations=annotations(events))


def annotations(events) -> dict[str, list[tuple[float, float]]]:
    """The host-side record_function ranges of the trace by name, in order:
    (start s, end s) on the trace's clock."""
    out: dict[str, list[tuple[float, float]]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ts = float(e["ts"]) / 1e6
            out.setdefault(e.get("name", "?"), []).append((ts, ts + float(e.get("dur", 0.0)) / 1e6))
    return {name: sorted(r) for name, r in out.items()}


def kernel_launches(events) -> list[tuple[float, float]]:
    """(launch call start s, kernel duration s) of each kernel of the
    trace, matched to its launch call (runtime or driver API) by the trace's
    correlation id."""
    launch_at = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime", "cuda_driver") and "Launch" in e.get("name", ""):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch_at[corr] = float(e["ts"]) / 1e6
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        corr = e.get("args", {}).get("correlation")
        if corr in launch_at:
            out.append((launch_at[corr], float(e.get("dur", 0.0)) / 1e6))
    return sorted(out)


def gaps(ref, rt, rl, rcost: float, answers, device) -> tuple[dict, int]:
    """ba_offline's numbers of every answer ((t, q, lm) on the host, its
    reported cost) against the reference's solution (rt, rl, rcost), the
    largest over the answers; and the number of distinct answers."""
    import torch

    rt, rl = rt.cpu().numpy(), rl.cpu().numpy()
    out = dict(cost_gap=0.0, reported_cost_gap=0.0, pose_gap_m=0.0, landmark_gap_m=0.0)
    evaluated = {}
    for (t, q, lm), reported in answers:
        key = (t.tobytes(), q.tobytes(), lm.tobytes())
        if key not in evaluated:
            f64 = lambda x: torch.as_tensor(x, device=device).to(torch.float64)
            evaluated[key] = (ref.cost(f64(t), f64(q), f64(lm)), float(np.abs(t - rt).max()),
                              float(np.percentile(np.linalg.norm(lm - rl, axis=-1), 99)))
        c, pg, lg = evaluated[key]
        out["cost_gap"] = max(out["cost_gap"], abs(c - rcost) / rcost)
        out["reported_cost_gap"] = max(out["reported_cost_gap"], abs(reported - c) / c)
        out["pose_gap_m"] = max(out["pose_gap_m"], pg)
        out["landmark_gap_m"] = max(out["landmark_gap_m"], lg)
    return out, len(evaluated)


def run(cell: dict, seed: int, seconds: float, trace: bool, t_process0: float, device: str = "cuda") -> dict:
    import torch

    from vision_slam_frontend_tpu_torch.backend.ba import BASolverConfig, _solver_form, optimize
    from vision_slam_frontend_tpu_torch.utils import profiling

    config, traffic = cell["config"], cell["traffic"]
    on_card = device == "cuda"
    if not on_card and traffic["landmarks"] * traffic["obs_per_landmark"] > CPU_MAX_OBSERVATIONS:
        raise Refused(f"up to {traffic['landmarks'] * traffic['obs_per_landmark']} observations: a size for the "
                      f"card; a CPU run takes a traffic file of at most {CPU_MAX_OBSERVATIONS}")
    settings = traffic.get("solver", {})
    if set(settings) - set(SOLVER_KEYS):
        raise Refused(f"the reference does not follow solver settings {sorted(set(settings) - set(SOLVER_KEYS))}")
    stated = {k: config.get(k) for k in STATED}
    if None in stated.values():
        raise Refused(f"the configuration states no {sorted(k for k, v in stated.items() if v is None)}: "
                      f"the references take them from it")
    if any(settings.get(k, v) != v for k, v in stated.items()):
        raise Refused(f"the traffic's solver sets {sorted(k for k in STATED if k in settings)} against the "
                      f"configuration's {stated}")
    solver = BASolverConfig(**settings)
    cam = ba_problem.camera(config)
    t0 = time.perf_counter()
    prob = ba_problem.make(config, traffic, seed, device)
    arrays = ba_problem.program_arrays(prob)
    t_made = time.perf_counter() - t0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    problem, camera = _program_problem(arrays, cam, device)
    route = _solver_form(problem, solver)
    if route != "pcg":
        raise Refused(f"these settings take the {route!r} route: ba_pcg_ref follows the pose-major PCG route only")
    shapes = dict(P=problem.num_poses, Mp=int(problem.pose_obs.shape[1]), L=problem.num_landmarks,
                  Ml=int(problem.lm_obs.shape[1]), rows=4 if problem.obs_pixel_right is not None else 2)

    spans = Spans(trace)

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
    rec, pcg_rec, slice_iters = None, None, 0
    if trace and on_card:
        s = Slice()
        _, info = one()
        rec = s.close()
        slice_iters = info["iterations"]
        if getattr(profiling, "recorded_counters", None) is not None:  # a program without counters has no ba.pcg span
            s = PcgSlice()
            one()
            pcg_rec = s.close()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    del problem
    if on_card:
        torch.cuda.empty_cache()

    # --- the reference, once, and every answer against it.
    t_ref = time.perf_counter()
    ref_in = dict(prob, poses_t=arrays["poses_t"], poses_q=arrays["poses_q"], landmarks=arrays["landmarks"],
                  pixel=prob["pixel"].astype(np.float32), pixel_right=prob["pixel_right"].astype(np.float32),
                  odom_t=arrays["odom_t"], odom_q=arrays["odom_q"])
    numbers, refs = {}, []
    for prefix, cg in (("", None), ("route_", stated["cg_iterations"])):
        ref = ba_pcg_ref.Problem(ref_in, cam, device, cg_iterations=cg)
        rt, _, rl, rcost, rit = ba_pcg_ref.solve(ref, stated["max_iterations"])
        got, distinct = gaps(ref, rt, rl, rcost, answers, device)
        numbers.update({prefix + k: v for k, v in got.items() if not (prefix and k == "reported_cost_gap")})
        refs.append((rcost, rit))
        del ref
    ref_s = time.perf_counter() - t_ref
    window_s = t_end - t_start
    n_obs = int(arrays["obs_mask"].sum())
    notes = [
        f"ba_solve_s over {len(answers)} solves in {window_s:.3f} s; LM iterations per solve {sorted(set(iters))}",
        f"route: {route} ({solver.cg_iterations} CG iterations a step, {solver.max_iterations} LM iterations at most; "
        f"the configuration states {stated['cg_iterations']} and {stated['max_iterations']})",
        f"problem: P={shapes['P']}, L={shapes['L']}, {n_obs} stereo observations, Mp={shapes['Mp']}, "
        f"Ml={shapes['Ml']}; made in {t_made:.2f} s",
        f"reference: exact step cost {refs[0][0]:.6g} after {refs[0][1]} iterations, the route's "
        f"{stated['cg_iterations']} CG iterations cost {refs[1][0]:.6g} after {refs[1][1]}, in {ref_s:.2f} s; "
        f"{distinct} distinct answers",
    ]
    ctx = dict(kind="ba", slice=rec, slice_iters=slice_iters, window_s=window_s, iterations=sum(iters),
               solve_s=solve_s, spans=spans, main_thread=threading.get_ident(), pcg=shapes, pcg_slice=pcg_rec)
    return dict(e2e={"ba_solve_s": window_s / len(answers), "setup_s": t_start - t_process0}, numbers=numbers,
                attempted=len(answers), failed=0, peak=peak, ctx=ctx, notes=notes)
