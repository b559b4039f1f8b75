"""Per-iteration collective counts of the distributed BA modes (port of
parallel/comm_report.py).

The JAX package compiles each mode on a virtual device mesh and sums the
collectives in the compiled HLO. The port's collectives are the shard
group's own calls (parallel/mesh), so this module runs one LM iteration of
each mode on an n-shard group and reads the group's counters: calls, and
bytes (each call's output payload, the JAX report's convention). Each
mode's count is pinned to its analytic form (`expected_counts`). With the
single-device iteration time T_c and link bandwidth W, `predict_efficiency`
turns the volume into a scaling estimate:

    efficiency(n) ~= 1 / (1 + n * t_comm / T_c)

Usage (an in-process 8-shard group; `--device cuda` on the card):
  python -m vision_slam_frontend_tpu_torch.parallel.comm_report [P L T_c] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

F32 = 4  # bytes


def predict_efficiency(
    T_c: float,
    bytes_per_iter: float,
    collectives_per_iter: float,
    n: int,
    bandwidth: float,
    hop_latency: float,
) -> dict:
    """Latency-aware ring-collective scaling prediction.

    Per iteration over n devices, a ring all-reduce of B payload bytes moves
    ~2B(n-1)/n bytes per device (bandwidth term) and takes 2(n-1) sequential
    hops (latency term). With c SEQUENTIAL collectives per iteration,

        t_comm(n) = 2 B (n-1)/n / W  +  c * 2 (n-1) * alpha
        eff(n)    = 1 / (1 + n * t_comm / T_c)

    where T_c is the measured single-device iteration time (so T_c/n is the
    ideal n-way compute time).

    Args: bandwidth in bytes/s, hop_latency in seconds.
    """
    t_bw = 2.0 * bytes_per_iter * (n - 1) / n / bandwidth
    t_lat = collectives_per_iter * 2.0 * (n - 1) * hop_latency
    t_comm = t_bw + t_lat
    return {
        "n": n,
        "t_bw_s": t_bw,
        "t_lat_s": t_lat,
        "t_comm_s": t_comm,
        "efficiency": 1.0 / (1.0 + n * t_comm / max(T_c, 1e-12)),
    }


def expected_counts(mode: str, P: int, L: int, cg_iters: int = 0, n_seg: int = 0, Ps: int = 0, Ls: int = 0,
                    level_a_iterations: int = 1) -> dict:
    """The collectives of one LM iteration of a mode (a sweep for segments),
    from the shapes alone.

      obs_sharded_pcg: V, the landmark gradient and U in one all-reduce
        (12L + 36P floats), the right-hand side's pose sum (6P), per CG
        iteration the landmark (3L) and pose (6P) partials of S x, the
        back-substitution (3L), the candidate cost (1): 4 + 2 cg calls;
      lm_sharded_dense: the pose partials (48P), the reduced camera matrix
        (36 P^2), the gathered landmark steps (3L): 3 calls (the cost is
        computed whole on every shard);
      segment_parallel: one sweep of k level-A iterations gathers the
        segments' costs before the loop and after each iteration (n_seg
        floats each) and their poses and landmarks once (n_seg (7 Ps + 3 Ls)
        floats): 2 + k calls.
    """
    if mode == "obs_sharded_pcg":
        floats = 12 * L + 36 * P + 6 * P + cg_iters * (3 * L + 6 * P) + 3 * L + 1
        return {"calls": 4 + 2 * cg_iters, "bytes": F32 * floats}
    if mode == "lm_sharded_dense":
        return {"calls": 3, "bytes": F32 * (48 * P + 36 * P * P + 3 * L)}
    if mode == "segment_parallel":
        k = level_a_iterations
        floats = (1 + k) * n_seg + n_seg * (7 * Ps + 3 * Ls)
        return {"calls": 2 + k, "bytes": F32 * floats}
    raise ValueError(f"unknown mode {mode!r}")


def report_modes(n_devices: int = 8, P: int = 256, L: int = 8192, obs: int = 5, device="cuda", cg_iters: int = 32,
                 group=None):
    """Run one LM iteration of each distributed mode (a sweep of one level-A
    iteration for segments) on `group` (default: an in-process n-shard group
    on `device`), at the BA benchmark's problem of that shape; return one
    dict per mode with the counted calls and bytes beside the analytic
    ones."""
    import numpy as np
    import torch

    from vision_slam_frontend_tpu_torch.backend import ba
    from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams
    from vision_slam_frontend_tpu_torch.io.synthetic import make_problem
    from vision_slam_frontend_tpu_torch.parallel.mesh import LocalShards
    from vision_slam_frontend_tpu_torch.parallel.segment_ba import build_segments, optimize_segments
    from vision_slam_frontend_tpu_torch.parallel.sharded_ba import (
        _lm_shard_inputs,
        _lm_sharded_plan,
        build_lm_sharded,
        lm_sharded_dense_step,
        pad_observations,
        shard_ba_problem,
    )

    device = torch.device(device)
    cam = CameraParams(fx=500.0, fy=500.0, cx=320.0, cy=240.0, R_cr=np.eye(3), t_cr=np.zeros(3)).to(device)
    problem = make_problem(P, L, obs, device=device)
    group = group or LocalShards(n_devices, device)
    n_devices = group.size
    hd, wt, wr = (ba._round_f32(x) for x in (4.0, 30.0, 60.0))
    lam = ba._round_f32(1e-3)
    results = []

    def measured(mode, run, **shape):
        group.reset_counts()
        run()
        exp = expected_counts(mode, P, L, **shape)
        results.append({"mode": mode, "n_devices": n_devices, "P": P, "L": L, "N": L * obs, **shape,
                        "calls": group.calls, "bytes": group.bytes, "expected_calls": exp["calls"],
                        "expected_bytes": exp["bytes"]})

    sharded = shard_ba_problem(pad_observations(problem, n_devices), group)

    def pcg_iteration():
        step = ba._solve_schur_pcg_sharded(*ba._linearize(cam, sharded, hd, wt, wr, True), sharded, lam, cg_iters,
                                           True, group)
        float(ba.sharded_cost(cam, ba._apply_step(sharded, step[0], step[1]), hd, wt, wr, True, group))

    measured("obs_sharded_pcg", pcg_iteration, cg_iters=cg_iters)

    d = _lm_shard_inputs(build_lm_sharded(problem, n_devices), group, device)
    plan = _lm_sharded_plan(d, P)
    free = ba._free_mask(problem, True, torch.float32)
    measured("lm_sharded_dense",
             lambda: lm_sharded_dense_step(cam, problem, d, plan, group, free, lam, hd, wt, wr, True))

    stacked, _ = build_segments(problem, n_devices)
    one = ba.BASolverConfig(max_iterations=1)
    measured("segment_parallel",
             lambda: optimize_segments(problem, mesh=group, cam=cam, solver=one, n_seg=n_devices, sweeps=1,
                                       polish_iterations=0),
             n_seg=n_devices, Ps=int(stacked.poses_t.shape[1]), Ls=int(stacked.landmarks.shape[1]))
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("P", type=int, nargs="?", default=256)
    ap.add_argument("L", type=int, nargs="?", default=8192)
    ap.add_argument("T_c", type=float, nargs="?", default=0.3, help="measured single-device s per LM iteration")
    ap.add_argument("--n_devices", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from vision_slam_frontend_tpu_torch.utils.device import resolve_device

    for r in report_modes(args.n_devices, args.P, args.L, device=resolve_device(args.device)):
        print(json.dumps(r))
        if r["mode"] == "obs_sharded_pcg":
            B, c = r["bytes"], r["calls"]
            preds = {
                "dcn_2hosts_10GBps_25us": predict_efficiency(args.T_c, B, c, 2, 10e9, 25e-6),
                "dcn_4hosts_10GBps_25us": predict_efficiency(args.T_c, B, c, 4, 10e9, 25e-6),
                "nvlink_8gpus_450GBps_2us": predict_efficiency(args.T_c, B, c, 8, 450e9, 2e-6),
            }
            print(json.dumps({"mode": "obs_sharded_pcg_predictions", "T_c_s": args.T_c,
                              **{k: {kk: round(vv, 6) for kk, vv in v.items()} for k, v in preds.items()}}))


if __name__ == "__main__":
    main()
