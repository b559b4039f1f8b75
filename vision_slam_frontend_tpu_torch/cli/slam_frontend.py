"""slam_frontend CLI of the PyTorch port: run the frontend, save the problem.

Usage:
  python -m vision_slam_frontend_tpu_torch.cli.slam_frontend \
      --input synthetic:20 --output /tmp/problem.npz [--device cuda]

Only the synthetic input (`synthetic[:N[:step]]`) is ported; bag, KITTI and
EuRoC inputs are not yet. The device defaults to `cuda`, where the step runs
the hand-written kernels; `--device cpu` runs their plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch


def iter_synthetic(spec: str):
    """`synthetic[:N[:step]]`: (kind, timestamp, payload) events of the
    JAX package's synthetic stereo world."""
    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig, generate_sequence

    parts = spec.split(":")
    n = int(parts[1]) if len(parts) > 1 else 20
    step = float(parts[2]) if len(parts) > 2 else 0.25
    for f in generate_sequence(num_frames=n, step=step, rig=SyntheticRig()):
        yield ("odometry", f.timestamp, (f.odom_translation, f.odom_rotation))
        yield ("stereo", f.timestamp, (f.left, f.right))


def resolve_device(name: str) -> torch.device:
    """The requested device; a CUDA request without a CUDA device fails."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: no CUDA device is available (the kernels run "
            "only on the GPU; pass --device cpu to run their plain PyTorch "
            "versions on the CPU)"
        )
    return device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="slam_frontend_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--input", required=True, help="synthetic[:N[:step]]")
    p.add_argument("--output", required=True, help="output SLAM problem (.npz)")
    p.add_argument("--max_poses", type=int, default=0, help="stop after this many SLAM poses (0 = all)")
    p.add_argument("--max_features", type=int, default=None, help="override feature capacity K")
    p.add_argument("--frame_life", type=int, default=None, help="override temporal window W")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("-v", "--verbosity", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.input.startswith("synthetic"):
        raise NotImplementedError(
            f"input {args.input!r}: only synthetic[:N[:step]] is ported; "
            "bag, KITTI and EuRoC inputs are not ported yet"
        )
    device = resolve_device(args.device)

    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig
    from vision_slam_frontend_tpu_torch.frontend import Frontend, FrontendConfig
    from vision_slam_frontend_tpu_torch.io.serialize import save_problem

    overrides = {}
    if args.max_features is not None:
        overrides["max_features"] = args.max_features
    if args.frame_life is not None:
        overrides["frame_life"] = args.frame_life
    config = FrontendConfig(calib=SyntheticRig().calib(), fast_threshold=12.0, **overrides)
    frontend = Frontend(config, device=device)
    frontend.verbosity = args.verbosity

    print(f"Processing {args.input} on {device}")
    t_start = time.perf_counter()
    frames_seen = 0
    n_poses = 0
    for kind, t, payload in iter_synthetic(args.input):
        if kind == "odometry":
            frontend.observe_odometry(*payload, t)
            continue
        frames_seen += 1
        if frontend.observe_image(*payload, t):
            n_poses += 1
        if args.max_poses > 0 and n_poses >= args.max_poses:
            break
    problem = frontend.get_slam_problem()  # waits for the last keyframe
    elapsed = time.perf_counter() - t_start
    print("Done processing input.")

    save_problem(args.output, problem, config=config, node_track_ids=frontend.node_track_ids)
    print(problem.summary())
    n_poses = frontend.get_num_poses()
    print(
        f"[perf] {frames_seen} stereo frames, {n_poses} keyframes in {elapsed:.2f}s "
        f"({frames_seen / max(elapsed, 1e-9):.1f} frames/s, "
        f"{n_poses / max(elapsed, 1e-9):.1f} keyframes/s)"
    )
    if args.verbosity > 0 and frontend.stats_summary():
        print(f"[stats] {frontend.stats_summary()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
