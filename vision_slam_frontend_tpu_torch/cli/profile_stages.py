"""profile_stages CLI of the PyTorch port: a per-stage wall-clock table of
the keyframe step (detect, match, filter, triangulate, ...) and the whole
step's time, synced and, on a GPU, enqueued.

Usage:
  python -m vision_slam_frontend_tpu_torch.cli.profile_stages [--max_features 512]
      [--frame_life 10] [--width 640] [--height 480] [--iters 10] [--windows 3]
      [--trace_dir /tmp/trace] [--device cuda | --cpu]

`--trace_dir` also records a torch.profiler trace of the run (CPU and, on a
GPU, CUDA activity) and writes it there as a Chrome trace. `--cpu` is
`--device cpu`.
"""

from __future__ import annotations

import argparse
import sys

from vision_slam_frontend_tpu_torch.utils.device import resolve_device

TRACE_FILE = "profile_stages_trace.json"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="profile_stages", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--max_features", type=int, default=512)
    p.add_argument("--frame_life", type=int, default=10)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--trace_dir", default=None, help="also record a torch.profiler trace here")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (--device cpu)")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else args.device)

    from vision_slam_frontend_tpu_torch.frontend.config import FrontendConfig
    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig
    from vision_slam_frontend_tpu_torch.utils.profiling import (
        format_stage_table,
        profile_keyframe_stages,
        start_trace,
        write_trace,
    )

    rig = SyntheticRig(width=args.width, height=args.height)
    config = FrontendConfig(calib=rig.calib(), max_features=args.max_features, frame_life=args.frame_life,
                            fast_threshold=12.0)
    print(f"Profiling keyframe stages on {device} (K={args.max_features}, W={args.frame_life}, "
          f"{args.width}x{args.height})...")
    prof = start_trace(device) if args.trace_dir else None
    timings = profile_keyframe_stages(config, image_shape=(args.height, args.width), iters=args.iters,
                                      windows=args.windows, device=device)
    if prof is not None:
        write_trace(prof, args.trace_dir, TRACE_FILE)
    print(format_stage_table(timings))
    return 0


if __name__ == "__main__":
    sys.exit(main())
