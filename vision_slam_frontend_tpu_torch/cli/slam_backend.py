"""slam_backend CLI of the PyTorch port: optimize a saved SLAM problem with
bundle adjustment.

Reads a problem npz (with the calibration the frontend CLI embeds, or
--config), chains matches into landmark tracks, runs LM with a dense-Cholesky
or PCG Schur solve, and writes the optimized problem + landmark cloud.

Usage:
  python -m vision_slam_frontend_tpu_torch.cli.slam_backend \
      --input problem.npz --output solved.npz [--ply map.ply] [--device cuda] [--verbose]

The device defaults to `cuda` and the run fails where there is no GPU;
`--device cpu` runs on the CPU. The JAX package's segment-parallel solver
(`--schur_solver segments`) and multi-device sharding (`--devices > 1`) are
not ported.
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
        "runs the same PCG; segments (the segment-parallel solver) is not ported",
    )
    p.add_argument("--cg_iterations", type=int, default=32)
    p.add_argument("--segments", type=int, default=0, help="segments for --schur_solver segments (not ported)")
    p.add_argument("--sweeps", type=int, default=4, help="sweeps for --schur_solver segments (not ported)")
    p.add_argument("--devices", type=int, default=0, help="shard over N devices (0 or 1: one device; N > 1 not ported)")
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
    if args.schur_solver == "segments":
        raise NotImplementedError(
            "--schur_solver segments: the segment-parallel solver is not ported yet (ROADMAP A13)"
        )
    if args.devices > 1:
        raise NotImplementedError(f"--devices {args.devices}: multi-GPU BA is not ported yet (ROADMAP A13)")
    from vision_slam_frontend_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)

    from vision_slam_frontend_tpu_torch.backend import BASolverConfig, build_ba_problem, optimize
    from vision_slam_frontend_tpu_torch.io.serialize import load_problem

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
    print(
        f"BA problem: {ba.num_poses} poses, {n_lm} landmarks, {n_obs} observations, "
        f"{int(ba.odom_mask.sum())} odometry factors on {device}"
    )

    solver = BASolverConfig(
        max_iterations=args.max_iterations,
        huber_delta=args.huber_delta,
        trim_threshold=args.trim_threshold,
        validate=args.validate,
        schur_solver=args.schur_solver,
        cg_iterations=args.cg_iterations,
    )
    t0 = time.perf_counter()
    opt, info = optimize(
        ba, cam=cam, solver=solver, verbose=args.verbose,
        checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every,
        resume=args.resume,
    )
    elapsed = time.perf_counter() - t0
    print(
        f"BA converged: cost {info['history'][0]:.1f} -> {info['cost']:.1f} in "
        f"{info['iterations']} LM iterations ({elapsed:.2f}s, "
        f"{info['trimmed']} observations trimmed)"
    )
    return _write_output(args, problem, opt, info, data, cam_to_robot)


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
