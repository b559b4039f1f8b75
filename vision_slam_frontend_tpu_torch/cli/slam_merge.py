"""slam_merge CLI of the PyTorch port: merge several session problems and
jointly optimize them.

N saved SLAM problems + initial SE(3) alignment guesses -> aligned
concatenation, cross-session landmark association, frozen-anchor joint
bundle adjustment -> one merged optimized map.

Usage:
  python -m vision_slam_frontend_tpu_torch.cli.slam_merge \\
      --inputs a.npz b.npz --output merged.npz [--device cuda] \\
      [--transforms "0,0,0,1,0,0,0;1.5,0,2.0,1,0,0,0"]  # tx,ty,tz,qw,qx,qy,qz per session
      [--assoc_radius 0.3] [--ply merged.ply]

The device defaults to `cuda` and the run fails where there is no GPU;
`--device cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def parse_transforms(spec: str, n: int):
    if not spec:
        return None
    parts = spec.split(";")
    if len(parts) != n:
        raise ValueError(f"--transforms has {len(parts)} entries for {n} inputs")
    out = []
    for p in parts:
        vals = [float(v) for v in p.split(",")]
        if len(vals) != 7:
            raise ValueError("each transform is tx,ty,tz,qw,qx,qy,qz")
        out.append((np.array(vals[:3]), np.array(vals[3:])))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="slam_merge_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--inputs", nargs="+", required=True, help="session npz files (>=2)")
    p.add_argument("--output", required=True, help="merged optimized npz")
    p.add_argument("--transforms", default="", help="per-session 'tx,ty,tz,qw,qx,qy,qz' separated by ';'")
    p.add_argument("--assoc_radius", type=float, default=0.3)
    p.add_argument("--no_freeze_anchor", action="store_true")
    p.add_argument("--max_iterations", type=int, default=10)
    p.add_argument("--huber_delta", type=float, default=4.0)
    p.add_argument("--trim_threshold", type=float, default=8.0)
    p.add_argument("--ply", default=None, help="merged pose-graph + landmark PLY")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if len(args.inputs) < 2:
        print("Need at least two --inputs sessions")
        return 1

    from vision_slam_frontend_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)

    from vision_slam_frontend_tpu_torch.backend import BASolverConfig, optimize
    from vision_slam_frontend_tpu_torch.backend.merge import merge_sessions, merge_slam_problems
    from vision_slam_frontend_tpu_torch.cli.slam_backend import _camera_from_npz
    from vision_slam_frontend_tpu_torch.io.serialize import load_problem, problem_to_arrays

    try:
        problems = [load_problem(path) for path in args.inputs]
        with np.load(args.inputs[0]) as raw:
            data0 = dict(raw)
    except (FileNotFoundError, ValueError, KeyError) as e:
        print(f"Unable to read inputs, reason:\n {e}")
        return 1
    transforms = parse_transforms(args.transforms, len(problems))

    if "calib_K_left" not in data0:
        print("First input lacks embedded calibration (write it with slam_frontend)")
        return 1
    cam, ext = _camera_from_npz(data0)

    ba, info = merge_sessions(
        problems,
        transforms=transforms,
        left_cam_to_robot=ext,
        assoc_radius=args.assoc_radius,
        freeze_anchor=not args.no_freeze_anchor,
        device=device,
    )
    print(
        f"Merged {info['num_sessions']} sessions: {info['num_poses']} poses, "
        f"{info['num_landmarks']} landmarks ({info['merged_landmark_pairs']} "
        f"cross-session associations)"
    )
    solver = BASolverConfig(
        max_iterations=args.max_iterations,
        huber_delta=args.huber_delta,
        trim_threshold=args.trim_threshold,
    )
    opt, oinfo = optimize(ba, cam=cam, solver=solver, verbose=args.verbose)
    print(
        f"Joint BA: cost {oinfo['history'][0]:.1f} -> {oinfo['cost']:.1f} "
        f"({oinfo['iterations']} iterations, {oinfo['trimmed']} trimmed)"
    )

    merged, _ = merge_slam_problems(problems, transforms)
    arrays = opt.to_numpy()
    for k, node in enumerate(merged.nodes):
        node.pose.loc = arrays["poses_t"][k]
        node.pose.angle = arrays["poses_q"][k]
    out = problem_to_arrays(merged)
    out["ba_landmarks"] = arrays["landmarks"]
    out["ba_landmark_mask"] = arrays["landmark_mask"]
    out["session_of_pose"] = info["session_of_pose"]
    for key in data0:
        if key.startswith("calib_"):
            out[key] = data0[key]
    np.savez_compressed(args.output, **out)
    print(f"Wrote {args.output}")
    if args.ply:
        from vision_slam_frontend_tpu_torch.viz.ply import export_ply

        print(f"Wrote {args.ply}: {export_ply(args.ply, merged, ext)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
