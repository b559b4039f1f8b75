"""slam_backend CLI of the PyTorch port: optimize a saved SLAM problem with
bundle adjustment.

Reads a problem npz (with the calibration the frontend CLI embeds, or
--config), chains matches into landmark tracks, runs LM with a dense-Cholesky
or PCG Schur solve (or the segment-parallel solver), and writes the optimized
problem + landmark cloud.

Usage:
  python -m vision_slam_frontend_tpu_torch.cli.slam_backend \
      --input problem.npz --output solved.npz [--ply map.ply] [--device cuda] [--verbose]
      [--schur_solver segments --segments 4 --sweeps 4] [--devices N]

The device defaults to `cuda` and the run fails where there is no GPU;
`--device cpu` runs on the CPU. `--devices N` (N > 1) starts N ranks of one
process group itself: NCCL on cuda:0..N-1 (it fails unless N CUDA devices are
visible), gloo with `--device cpu`.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="slam_backend_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--input", required=True, help="SLAM problem npz (from slam_frontend)")
    p.add_argument("--output", required=True, help="optimized problem npz")
    p.add_argument("--ply", default=None, help="optimized pose-graph + landmark PLY")
    p.add_argument("--config", default=None, help="YAML config (else calib embedded in input)")
    p.add_argument("--max_iterations", type=int, default=15)
    p.add_argument("--huber_delta", type=float, default=4.0)
    p.add_argument("--trim_threshold", type=float, default=8.0)
    p.add_argument("--min_track_length", type=int, default=2)
    p.add_argument("--max_landmarks", type=int, default=None)
    p.add_argument(
        "--checkpoint", default=None,
        help="snapshot solver state to this npz every --checkpoint_every LM iterations",
    )
    p.add_argument("--checkpoint_every", type=int, default=5)
    p.add_argument(
        "--resume", action="store_true",
        help="resume from --checkpoint if it exists (fresh run otherwise)",
    )
    p.add_argument(
        "--validate", action="store_true",
        help="sanitizer mode: check each solver step for non-finite updates",
    )
    p.add_argument(
        "--schur_solver",
        choices=["auto", "dense", "pcg", "pcg_chunked", "segments"],
        default="auto",
        help="inner reduced-camera solver: dense Cholesky or matrix-free PCG "
        "(auto: dense up to BASolverConfig.dense_max_poses poses); pcg_chunked "
        "runs the same PCG; segments: the segment-parallel two-level solver for "
        "long trajectories (parallel/segment_ba.py)",
    )
    p.add_argument("--cg_iterations", type=int, default=32)
    p.add_argument(
        "--segments", type=int, default=0,
        help="trajectory segments for --schur_solver segments (0: max(devices, 4))",
    )
    p.add_argument("--sweeps", type=int, default=4, help="level-A/level-B sweeps for --schur_solver segments")
    p.add_argument(
        "--devices", type=int, default=0,
        help="solve over N ranks, one device each (0 or 1: one device). Observations shard over them "
        "(the observation-sharded PCG), or segments do with --schur_solver segments",
    )
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--verbose", action="store_true")
    return p


def _camera_from_npz(data: dict):
    """(CameraParams, left camera -> robot 4x4) from a frontend npz's calib_* keys."""
    from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams

    K = data["calib_K_left"]
    ext = data["calib_left_cam_to_robot"]
    kwargs = {}
    if "calib_right_extrinsic" in data and "calib_K_right" in data:
        Kr = data["calib_K_right"]
        A_r = data["calib_right_extrinsic"]
        kwargs = dict(fx_r=Kr[0, 0], fy_r=Kr[1, 1], cx_r=Kr[0, 2], cy_r=Kr[1, 2], R_rl=A_r[:, :3], t_rl=A_r[:, 3])
    cam = CameraParams(fx=K[0, 0], fy=K[1, 1], cx=K[0, 2], cy=K[1, 2], R_cr=ext[:3, :3], t_cr=ext[:3, 3], **kwargs)
    return cam, ext


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.devices > 1:
        return _run_ranks(args, argv)
    from vision_slam_frontend_tpu_torch.utils.device import resolve_device

    return _solve(args, resolve_device(args.device))


def _run_ranks(args, argv) -> int:
    """Start --devices ranks of one process group, each running the solve on
    its device; rank 0 writes the output. Returns 0 when every rank did."""
    import socket

    import torch
    import torch.multiprocessing as mp

    n = args.devices
    if args.checkpoint:
        print("--checkpoint: solver checkpoints hold one process's problem; not available with --devices > 1",
              file=sys.stderr)
        return 2
    if torch.device(args.device).type == "cuda":
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < n:
            print(f"--devices {n}: needs {n} CUDA devices, found {found} (NCCL puts one rank on each; "
                  "--device cpu runs the ranks on the CPU over gloo)", file=sys.stderr)
            return 2
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    try:
        mp.start_processes(_rank_main, args=(list(argv) if argv is not None else sys.argv[1:], n, port), nprocs=n,
                           join=True, start_method="spawn")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        print(f"--devices {n}: {e}", file=sys.stderr)
        return 1
    return 0


def _rank_main(rank: int, argv: list, n: int, port: int) -> None:
    """One rank of --devices: join the group and solve (spawned)."""
    import torch
    import torch.distributed as dist

    from vision_slam_frontend_tpu_torch.parallel.mesh import initialize_distributed, make_mesh

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(max(1, torch.get_num_threads() // n))  # the ranks share the host's cores
    initialize_distributed(f"localhost:{port}", n, rank, device=device)
    try:
        rc = _solve(args, device, make_mesh(n, device))
    finally:
        dist.destroy_process_group()
    if rc:
        sys.exit(rc)


def _solve(args, device, group=None) -> int:
    """Load, build the BA problem, solve on `device` (over `group`'s ranks
    when one is given) and write the output (rank 0)."""
    from vision_slam_frontend_tpu_torch.backend import BASolverConfig, build_ba_problem, optimize
    from vision_slam_frontend_tpu_torch.io.serialize import load_problem

    lead = group is None or group.rank == 0

    try:
        problem = load_problem(args.input)
        with np.load(args.input) as raw:
            data = dict(raw)
    except (FileNotFoundError, ValueError, KeyError) as e:
        print(f"Unable to read {args.input}, reason:\n {e}")
        return 1

    if args.config:
        from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams
        from vision_slam_frontend_tpu_torch.frontend.config import FrontendConfig

        config = FrontendConfig.load(args.config)
        cam = CameraParams.from_config(config)
        cam_to_robot = np.asarray(config.left_cam_to_robot)
    elif "calib_K_left" in data:
        cam, cam_to_robot = _camera_from_npz(data)
    else:
        print("No calibration: pass --config or use a frontend-written npz")
        return 1

    ba = build_ba_problem(
        problem,
        left_cam_to_robot=cam_to_robot,
        min_track_length=args.min_track_length,
        max_landmarks=args.max_landmarks,
        device=device,
    )
    n_lm = int(ba.landmark_mask.sum())
    n_obs = int(ba.obs_mask.sum())
    if lead:
        print(
            f"BA problem: {ba.num_poses} poses, {n_lm} landmarks, {n_obs} observations, "
            f"{int(ba.odom_mask.sum())} odometry factors on {device}"
            + (f" ({group.size} ranks)" if group is not None else "")
        )

    solver = BASolverConfig(
        max_iterations=args.max_iterations,
        huber_delta=args.huber_delta,
        trim_threshold=args.trim_threshold,
        validate=args.validate,
        schur_solver=args.schur_solver,
        cg_iterations=args.cg_iterations,
    )
    verbose = args.verbose and lead
    t0 = time.perf_counter()
    if args.schur_solver == "segments":
        opt, info, n_seg = _solve_segments(args, ba, cam, solver, group, verbose)
        if lead:
            print(
                f"BA (segments={n_seg}, sweeps={args.sweeps}) converged: cost "
                f"{info['history'][0]:.1f} -> {info['cost']:.1f} in "
                f"{info['iterations']} LM iterations ({time.perf_counter() - t0:.2f}s)"
            )
        return _write_output(args, problem, opt, info, data, cam_to_robot) if lead else 0
    if group is not None:
        from vision_slam_frontend_tpu_torch.parallel.sharded_ba import optimize_sharded, pad_observations

        ba = pad_observations(ba, group.size)
        if lead:
            print(f"Sharded {n_obs} observations over {group.size} devices")
        opt, info = optimize_sharded(ba, group, cam=cam, solver=solver, verbose=verbose)
    else:
        opt, info = optimize(
            ba, cam=cam, solver=solver, verbose=verbose,
            checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every,
            resume=args.resume,
        )
    elapsed = time.perf_counter() - t0
    if not lead:
        return 0
    print(
        f"BA converged: cost {info['history'][0]:.1f} -> {info['cost']:.1f} in "
        f"{info['iterations']} LM iterations ({elapsed:.2f}s, "
        f"{info['trimmed']} observations trimmed)"
    )
    return _write_output(args, problem, opt, info, data, cam_to_robot)


def _solve_segments(args, ba, cam, solver, group, verbose):
    """--schur_solver segments: the optimize pre-trim at the initial
    estimate, the segment-parallel solve, then one tightening trim at the
    converged estimate and one re-solve. Returns (problem, info, n_seg)."""
    from vision_slam_frontend_tpu_torch.backend.ba import _reproj_residual_norms
    from vision_slam_frontend_tpu_torch.parallel.segment_ba import optimize_segments

    n_seg = args.segments or max(args.devices, 4)
    cam = cam.to(ba.device)
    n_trimmed = 0
    if solver.trim_threshold > 0:
        # Same pre-trim rule as backend/ba.optimize: gross outliers are
        # easiest to identify at the initial estimate.
        keep = ba.obs_mask & (_reproj_residual_norms(cam, ba) < 10.0 * solver.trim_threshold)
        n_trimmed = int(ba.obs_mask.sum() - keep.sum())
        ba = ba.replace(obs_mask=keep)
    run = dict(mesh=group, cam=cam, solver=solver, n_seg=n_seg, sweeps=args.sweeps, verbose=verbose)
    opt, info = optimize_segments(ba, **run)
    if solver.trim_threshold > 0:
        keep = opt.obs_mask & (_reproj_residual_norms(cam, opt) < solver.trim_threshold)
        dropped = int(opt.obs_mask.sum() - keep.sum())
        if dropped:
            n_trimmed += dropped
            opt, info2 = optimize_segments(opt.replace(obs_mask=keep), **run)
            info = dict(info2, history=info["history"] + info2["history"],
                        iterations=info["iterations"] + info2["iterations"])
    info["trimmed"] = n_trimmed
    return opt, info, n_seg


def _write_output(args, problem, opt, info, data, cam_to_robot) -> int:
    """Write the optimized problem: the original structure with updated
    poses, plus the optimized landmark cloud and the cost history."""
    from vision_slam_frontend_tpu_torch.io.serialize import problem_to_arrays

    arrays = opt.to_numpy()
    for k, node in enumerate(problem.nodes):
        node.pose.loc = arrays["poses_t"][k]
        node.pose.angle = arrays["poses_q"][k]
    out = problem_to_arrays(problem)
    out["ba_landmarks"] = arrays["landmarks"]
    out["ba_landmark_mask"] = arrays["landmark_mask"]
    out["ba_cost_history"] = np.asarray(info["history"])
    for key in data:
        if key.startswith("calib_"):
            out[key] = data[key]
    np.savez_compressed(args.output, **out)
    print(f"Wrote {args.output}")
    if args.ply:
        from vision_slam_frontend_tpu_torch.viz.ply import export_ply

        print(f"Wrote {args.ply}: {export_ply(args.ply, problem, cam_to_robot)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
