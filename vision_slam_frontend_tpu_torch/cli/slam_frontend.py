"""slam_frontend CLI of the PyTorch port: run the frontend, save the problem.

Usage:
  python -m vision_slam_frontend_tpu_torch.cli.slam_frontend \
      --input synthetic:20 --output /tmp/problem.npz [--device cuda] \
      [--descriptor_family orb|brisk|freak|akaze|sift] [--local_ba 8] \
      [--checkpoint_every N] [--resume CKPT] [--interrupt_after N] \
      [--validate] [-v 2]

Only the synthetic input (`synthetic[:N[:step]]`) is ported; bag, KITTI and
EuRoC inputs are not yet. The device defaults to `cuda`, where the step runs
the hand-written kernels; `--device cpu` runs their plain PyTorch versions.
`--local_ba N` bundle-adjusts the last N keyframes after each new keyframe,
pipelined one keyframe deep (backend/local_ba.py); `-v 2` logs each applied
solve. The run ends with a frame-latency line (percentiles over every stereo
frame's host-loop time, peak RSS sampled after each frame, and peak device
memory on a GPU).

`--checkpoint_every N` writes a resumable snapshot to `<output>.ckpt.npz`
every N keyframes (after applying any in-flight local-BA solve); `--resume`
restores one and skips the events at or before its last odometry time. A
SIGINT stops the run after the current frame and writes the partial problem
and a checkpoint, then exits with 130; a second SIGINT aborts.
`--interrupt_after N` raises that SIGINT after N stereo frames. `--validate`
checks every keyframe's outputs (utils/checks.py) as it is fetched.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time

import numpy as np

from vision_slam_frontend_tpu_torch.backend.local_ba import LocalBAState, windowed_local_ba
from vision_slam_frontend_tpu_torch.utils.device import resolve_device


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


def _apply_local_ba(frontend, state, ba_live, verbosity: int) -> None:
    """Apply the in-flight local-BA solve, if any, and write its poses into
    the frontend. The solve was dispatched one keyframe earlier: the log
    names the newest keyframe of the window it refined."""
    updated, info = state.flush()
    if updated and ba_live is not None:
        frontend.update_poses(ba_live.nodes)
        if verbosity > 1:
            steps = "".join("1" if a else "0" for a in info["accepted"])
            print(
                f"[local-ba] applied the solve dispatched at keyframe {info['node_idx']}: refined "
                f"{updated} poses (cost {info['history'][0]:.4f} -> {info['cost']:.4f}, steps accepted {steps})"
            )


def _rss_mb() -> float:
    """This process's resident set now (/proc/self/statm), in MB; NaN where
    there is no /proc. getrusage's ru_maxrss is not used: Linux carries it
    across fork and exec, so a CLI started by a larger process would report
    that process's peak."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20
    except OSError:
        return float("nan")


def _latency_line(frame_lat, peak_rss_mb, device) -> str:
    """The run's frame-latency percentiles, peak RSS (sampled after each
    frame) and, on a GPU, peak device memory."""
    import torch

    lat = np.sort(np.asarray(frame_lat))

    def pct(q):
        return lat[min(int(q * len(lat)), len(lat) - 1)] * 1000

    line = (
        f"[perf] frame latency ms p50={pct(0.50):.1f} p90={pct(0.90):.1f} "
        f"p99={pct(0.99):.1f} max={lat[-1] * 1000:.1f}; peak RSS {peak_rss_mb:.0f} MB"
    )
    if device.type == "cuda":
        line += f"; peak device memory {torch.cuda.max_memory_allocated(device) / 2**20:.0f} MB"
    return line


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
    p.add_argument(
        "--descriptor_family", default=None,
        help="descriptor family from the registry (orb, brisk, freak, akaze, sift): the "
        "reference's -descriptor_extract_type switch",
    )
    p.add_argument(
        "--local_ba", type=int, default=0,
        help="run windowed local bundle adjustment over the last N keyframes "
        "after each new keyframe (0 = off)",
    )
    p.add_argument(
        "--checkpoint_every", type=int, default=0,
        help="write a resumable snapshot every N keyframes (to <output>.ckpt.npz)",
    )
    p.add_argument("--resume", default=None, help="resume from a checkpoint file")
    p.add_argument(
        "--validate", action="store_true",
        help="check every keyframe's invariants (NaN, bounds, indices)",
    )
    p.add_argument(
        "--interrupt_after", type=int, default=0, metavar="N",
        help="raise SIGINT after N stereo frames (a deterministic test of the "
        "graceful-interrupt path; 0 = off)",
    )
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

    overrides = {}
    if args.max_features is not None:
        overrides["max_features"] = args.max_features
    if args.frame_life is not None:
        overrides["frame_life"] = args.frame_life
    if args.descriptor_family is not None:
        overrides["descriptor_family"] = args.descriptor_family
    if args.validate:
        overrides["validate"] = True
    config = FrontendConfig(calib=SyntheticRig().calib(), fast_threshold=12.0, **overrides)
    frontend = Frontend(config, device=device)
    frontend.verbosity = args.verbosity
    resume_t = -float("inf")
    if args.resume:
        resume_t = frontend.load_checkpoint(args.resume)
        print(
            f"Resumed from {args.resume}: {frontend.get_num_poses()} poses, "
            f"skipping events at t <= {resume_t:.6f}"
        )
    ckpt_path = args.output + ".ckpt.npz"

    # SIGINT stops the run after the current frame; the partial problem and
    # a checkpoint are written below. A second SIGINT aborts.
    interrupted = False

    def on_sigint(signum, frame):
        nonlocal interrupted
        if interrupted:
            signal.signal(signal.SIGINT, prev_sigint or signal.SIG_DFL)
            raise KeyboardInterrupt
        interrupted = True
        print("\n[signal] SIGINT: stopping after the current frame; writing the partial problem and a "
              "checkpoint (SIGINT again to abort)")

    try:
        prev_sigint = signal.signal(signal.SIGINT, on_sigint)
        installed = True
    except ValueError:  # not the main thread: no handler
        prev_sigint, installed = None, False
    try:
        return _run(args, device, config, frontend, resume_t, ckpt_path, lambda: interrupted)
    finally:
        if installed:
            signal.signal(signal.SIGINT, prev_sigint or signal.SIG_DFL)


def _run(args, device, config, frontend, resume_t: float, ckpt_path: str, interrupted) -> int:
    """The CLI's event loop and epilogue; `interrupted()` reads the SIGINT
    flag. Returns the exit code (130 after an interrupt)."""
    from vision_slam_frontend_tpu_torch.io.serialize import save_problem

    print(f"Processing {args.input} on {device}")
    t_start = time.perf_counter()
    frames_seen = 0
    n_poses = last_ckpt_poses = frontend.get_num_poses()
    frame_lat = []  # each stereo frame's host-loop time (s)
    peak_rss_mb = _rss_mb()
    lba_ms = []  # each keyframe's local-BA host time: apply, window build, dispatch
    steady_from = None  # (time, frames, keyframes) when the first local-BA dispatch returned
    local_ba = LocalBAState() if args.local_ba > 0 else None  # this Frontend's in-flight solve
    ba_live = None  # the SLAMProblem whose nodes the in-flight solve updates
    for kind, t, payload in iter_synthetic(args.input):
        if interrupted():
            break
        if t <= resume_t:
            continue
        if kind == "odometry":
            frontend.observe_odometry(*payload, t)
            continue
        frames_seen += 1
        t_frame = time.perf_counter()
        added = frontend.observe_image(*payload, t)
        if args.interrupt_after > 0 and frames_seen >= args.interrupt_after:
            signal.raise_signal(signal.SIGINT)
        # Keyframes counted here: get_num_poses would flush the frontend's
        # one-deep result pipeline every frame.
        if added:
            n_poses += 1
        if added and local_ba is not None and n_poses >= 4:
            t_lba = time.perf_counter()
            # Pipelined one keyframe deep: apply keyframe k-1's solve (its
            # device work and fetch overlapped this frame), push the refined
            # poses into the frontend, then dispatch this keyframe's window:
            # the synchronous schedule's math without its wait.
            _apply_local_ba(frontend, local_ba, ba_live, args.verbosity)
            ba_live = frontend.get_slam_problem()
            windowed_local_ba(ba_live, config, window=args.local_ba, pipeline=True, state=local_ba, device=device)
            if args.verbosity > 1 and not local_ba.in_flight:
                print(f"[local-ba] keyframe {n_poses - 1}: window has no vision factors, nothing dispatched")
            lba_ms.append((time.perf_counter() - t_lba) * 1e3)
            if steady_from is None:
                steady_from = (time.perf_counter(), frames_seen, n_poses)
        if args.checkpoint_every > 0 and n_poses > last_ckpt_poses and n_poses % args.checkpoint_every == 0:
            if local_ba is not None:  # the checkpoint holds the refined poses
                _apply_local_ba(frontend, local_ba, ba_live, args.verbosity)
            frontend.save_checkpoint(ckpt_path)
            last_ckpt_poses = n_poses
            if args.verbosity > 0:
                print(f"[checkpoint] {n_poses} poses -> {ckpt_path}")
        frame_lat.append(time.perf_counter() - t_frame)
        peak_rss_mb = max(peak_rss_mb, _rss_mb())
        if args.max_poses > 0 and n_poses >= args.max_poses:
            break
    if local_ba is not None:
        _apply_local_ba(frontend, local_ba, ba_live, args.verbosity)
    if interrupted():
        frontend.save_checkpoint(ckpt_path)
        print(f"[signal] interrupted at {n_poses} keyframes: checkpoint -> {ckpt_path} "
              f"(resume with --resume {ckpt_path})")
    problem = frontend.get_slam_problem()  # waits for the last keyframe
    t_end = time.perf_counter()
    elapsed = t_end - t_start
    print("Done processing input.")

    save_problem(args.output, problem, config=config, node_track_ids=frontend.node_track_ids)
    print(problem.summary())
    n_poses = frontend.get_num_poses()
    print(
        f"[perf] {frames_seen} stereo frames, {n_poses} keyframes in {elapsed:.2f}s "
        f"({frames_seen / max(elapsed, 1e-9):.1f} frames/s, "
        f"{n_poses / max(elapsed, 1e-9):.1f} keyframes/s)"
    )
    if frame_lat:
        print(_latency_line(frame_lat, peak_rss_mb, device))
    if lba_ms:
        t0, frames0, poses0 = steady_from
        steady_s = max(t_end - t0, 1e-9)
        print(
            f"[perf] local BA host time per keyframe (apply, window build, dispatch): first "
            f"{lba_ms[0]:.1f} ms, median {float(np.median(lba_ms)):.1f} ms over {len(lba_ms)} keyframes; "
            f"after the first dispatch {(frames_seen - frames0) / steady_s:.2f} frames/s, "
            f"{(n_poses - poses0) / steady_s:.2f} keyframes/s"
        )
    if args.verbosity > 0 and frontend.stats_summary():
        print(f"[stats] {frontend.stats_summary()}")
    return 130 if interrupted() else 0  # 130: interrupted, by convention


if __name__ == "__main__":
    sys.exit(main())
