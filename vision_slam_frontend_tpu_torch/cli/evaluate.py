"""evaluate CLI of the PyTorch port: trajectory accuracy (ATE/RPE) of a SLAM
problem against ground truth (a numpy copy of the JAX package's CLI).

Loads an (optimized) problem npz and a ground-truth trajectory, and reports
ATE RMSE (aligned and raw) and RPE.

Ground-truth formats:
  - KITTI poses .txt (3x4 row-major per line)
  - TUM .txt (timestamp tx ty tz qx qy qz qw)
  - another problem .npz (its node poses)

Usage:
  python -m vision_slam_frontend_tpu_torch.cli.evaluate \
      --est solved.npz --gt poses.txt [--gt_format kitti] [--delta 1] [--align]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def load_trajectory(path: str, fmt: str) -> np.ndarray:
    if fmt == "npz" or path.endswith(".npz"):
        with np.load(path) as data:
            return np.asarray(data["nodes_loc"], np.float64)
    arr = np.loadtxt(path)
    if fmt == "kitti" or (fmt == "auto" and arr.ndim == 2 and arr.shape[1] == 12):
        return arr.reshape(-1, 3, 4)[:, :, 3]
    if fmt == "tum" or (fmt == "auto" and arr.ndim == 2 and arr.shape[1] == 8):
        return arr[:, 1:4]
    raise ValueError(f"Cannot interpret ground truth {path} (shape {arr.shape}); pass --gt_format")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="evaluate", description=__doc__)
    p.add_argument("--est", required=True, help="estimated problem npz (or trajectory txt)")
    p.add_argument("--gt", required=True, help="ground-truth trajectory")
    p.add_argument("--gt_format", choices=["auto", "kitti", "tum", "npz"], default="auto")
    p.add_argument("--est_format", choices=["auto", "kitti", "tum", "npz"], default="auto")
    p.add_argument("--delta", type=int, default=1, help="RPE step")
    p.add_argument("--align", action="store_true", help="SE(3)-align before ATE (default: report both)")
    p.add_argument("--scale", action="store_true", help="Sim(3) alignment (monocular-style)")
    args = p.parse_args(argv)

    from vision_slam_frontend_tpu_torch.backend.metrics import ate_rmse, rpe_rmse

    try:
        est = load_trajectory(args.est, args.est_format)
        gt = load_trajectory(args.gt, args.gt_format)
    except (FileNotFoundError, ValueError, KeyError) as e:
        print(f"Unable to read trajectories, reason:\n {e}")
        return 1
    n = min(len(est), len(gt))
    if n < 2:
        print(f"Too few corresponding poses: est={len(est)}, gt={len(gt)}")
        return 1
    if len(est) != len(gt):
        print(f"[warn] length mismatch est={len(est)} gt={len(gt)}; using first {n}")
    est, gt = est[:n], gt[:n]

    result = {
        "num_poses": n,
        "ate_rmse_raw": ate_rmse(est, gt, align=False),
        "ate_rmse_aligned": ate_rmse(est, gt, align=True, with_scale=args.scale),
        "rpe_rmse": rpe_rmse(est, gt, delta=args.delta),
        "trajectory_length": float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=-1))),
    }
    print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v) for k, v in result.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
