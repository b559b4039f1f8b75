"""slam_frontend CLI of the PyTorch port: run the frontend, save the problem.

Usage:
  python -m vision_slam_frontend_tpu_torch.cli.slam_frontend \
      --input path/to.bag|KITTI_SEQ_DIR|EUROC_DIR|synthetic:20 \
      --output /tmp/problem.npz [--device cuda] [--config rig.yaml] \
      [--dataset auto|bag|kitti|euroc|synthetic] [--sequence 00] \
      [--left_image_topic T] [--right_image_topic T] [--odom_topic T] \
      [--no_prefetch] [--output_bag out.bag] [--ply map.ply] [--html map.html] \
      [--descriptor_family orb|brisk|freak|akaze|sift] [--local_ba 8] \
      [--checkpoint_every N] [--resume CKPT] [--interrupt_after N] \
      [--validate] [--visualize [--visualize_every N]] [--save_debug] \
      [--profile_dir DIR] [-v 2]

Inputs: a ROS1 bag (stereo sensor_msgs/CompressedImage topics paired by equal
stamps, nav_msgs/Odometry; read by the native C++ scanner where it is built,
`VSF_DISABLE_NATIVE=1` to use the Python reader), a KITTI odometry sequence,
an EuRoC ASL directory, or the synthetic world (`synthetic[:N[:step]]`);
auto-detected, or named by `--dataset`. `--config` loads a YAML config and
calibration (the JAX package's `FrontendConfig.save` format); without it
the calibration comes from the dataset (KITTI calib.txt, EuRoC sensor.yaml,
the synthetic rig) or the default rig. Bag, KITTI and EuRoC events are read
and decoded on a producer thread ahead of the frontend (`--no_prefetch`
turns that off); `-v 1` prints the JPEG or image decoder taken.

The device defaults to `cuda`, where the step runs the hand-written kernels;
`--device cpu` runs their plain PyTorch versions.
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
`--output_bag` also writes the reference-format ROS bag (extrinsics,
intrinsics, slam_problem topics), `--ply` a pose-graph + landmark PLY and
`--html` a standalone viewer.

`--visualize` appends each keyframe's delta to the auto-refreshing page
`<output>_live.html` (every `--visualize_every` keyframes, and once more at
the end); it reads the frontend's materialized problem, so the one-deep
pipeline is not flushed. `--save_debug` writes each keyframe's stereo and
match debug images to `<output>_debug/stereo_%05d.png` and `match_%05d.png`
as the keyframe is materialized (memory stays flat). `--profile_dir DIR`
records a torch.profiler trace of the run (CPU and, on a GPU, CUDA
activity) and writes it to DIR as a Chrome trace. None of them changes the
saved npz.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import queue
import signal
import sys
import threading
import time
from typing import Iterator, Tuple

import numpy as np

from vision_slam_frontend_tpu_torch.backend.local_ba import LocalBAState, windowed_local_ba
from vision_slam_frontend_tpu_torch.utils.device import resolve_device
from vision_slam_frontend_tpu_torch.utils.profiling import span, start_trace, write_trace

Event = Tuple[str, float, tuple]  # (kind, timestamp, payload)


def iter_synthetic(spec: str) -> Iterator[Event]:
    """`synthetic[:N[:step]]`: (kind, timestamp, payload) events of the
    JAX package's synthetic stereo world."""
    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig, generate_sequence

    parts = spec.split(":")
    n = int(parts[1]) if len(parts) > 1 else 20
    step = float(parts[2]) if len(parts) > 2 else 0.25
    for f in generate_sequence(num_frames=n, step=step, rig=SyntheticRig()):
        yield ("odometry", f.timestamp, (f.odom_translation, f.odom_rotation))
        yield ("stereo", f.timestamp, (f.left, f.right))


def _bag_messages(path: str, topics, verbosity: int):
    """Parsed bag messages in file order: through the native C++ scanner
    where it is built and indexes records (not with VSF_DISABLE_NATIVE=1),
    else the pure-Python reader."""
    from vision_slam_frontend_tpu_torch.io import native_loader, rosbag

    if os.environ.get("VSF_DISABLE_NATIVE") != "1" and native_loader.native_available():
        try:
            reader = native_loader.NativeBagReader(path)
        except ValueError:
            reader = None
        if reader is not None:
            with reader:
                if len(reader) > 0:
                    if verbosity > 0:
                        print(f"[native] C++ bag scanner: {len(reader)} records")
                    type_by_topic = {t: ty for t, ty in reader.connections.values()}
                    for topic, t_ns, raw in reader.read_messages(topics=list(topics)):
                        parser = rosbag.DESERIALIZERS.get(type_by_topic.get(topic, ""))
                        yield topic, t_ns, (parser(raw) if parser else {"raw": raw})
                    return
    yield from rosbag.read_messages(path, topics=list(topics))


def iter_bag(path: str, left_topic: str, right_topic: str, odom_topic: str, verbosity: int) -> Iterator[Event]:
    """(kind, timestamp, payload) events of a ROS1 bag: odometry as it comes,
    and a stereo pair when a right image carries the stamp of the pending
    left one (the reference pairs by equal stamps; unpaired images are
    skipped)."""
    from vision_slam_frontend_tpu_torch.io.image import decode_compressed_image

    pending_left = None  # (stamp_ns, image message)
    for topic, t_ns, msg in _bag_messages(path, [left_topic, right_topic, odom_topic], verbosity):
        if topic == odom_topic:
            if verbosity > 1:
                print(f"Odometry t={t_ns * 1e-9:.6f}")
            yield ("odometry", t_ns * 1e-9, (msg["position"], msg["orientation_wxyz"]))
        elif topic == left_topic:
            pending_left = (msg["stamp_ns"], msg)
        elif topic == right_topic:
            if pending_left is None or pending_left[0] != msg["stamp_ns"]:
                continue
            t = msg["stamp_ns"] * 1e-9
            if verbosity > 1:
                print(f"CompressedImage t={t:.6f}")
            left = decode_compressed_image(pending_left[1])
            right = decode_compressed_image(msg)
            pending_left = None
            yield ("stereo", t, (left, right))


def prefetch_events(events: Iterator[Event], depth: int = 16) -> Iterator[Event]:
    """Decode ahead: run the event source (file reads, JPEG or PNG decode) on
    a producer thread feeding a bounded queue, so the host work of frame
    k + 1 overlaps frame k's step. The decoders and file reads release the
    GIL. The images stay host arrays: Frontend uploads them. Each event's
    read and decode is an `input.decode` span on the producer thread, each
    wait of the consumer on the queue an `input.wait` span.

    If the consumer stops early (SIGINT, --max_poses, close()), its finally
    sets `stop`; the producer's bounded put polls it, so the thread exits
    instead of blocking on a full queue. An exception in the producer is
    raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    done = object()
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            while True:
                with span("input.decode"):
                    item = next(events, done)
                if item is done:
                    break
                if stop.is_set() or not put(item):
                    return
            put(done)
        except BaseException as e:  # handed to the consumer, which raises it
            put(e)
        finally:
            if hasattr(events, "close"):
                events.close()  # releases the source's files now, not at garbage collection

    threading.Thread(target=producer, daemon=True, name="vsf-prefetch").start()
    try:
        while True:
            with span("input.wait"):
                item = q.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def detect_dataset(input_spec: str) -> str:
    if input_spec.startswith("synthetic"):
        return "synthetic"
    if input_spec.endswith(".bag"):
        return "bag"
    if os.path.isdir(input_spec):
        if os.path.isdir(os.path.join(input_spec, "mav0")):
            return "euroc"
        if os.path.isdir(os.path.join(input_spec, "image_0")) or os.path.isdir(os.path.join(input_spec, "image_00")):
            return "kitti"
    raise ValueError(f"Cannot auto-detect dataset type of {input_spec!r}; pass --dataset")


def make_config(args, dataset: str):
    """The run's FrontendConfig: --config, else the dataset's calibration;
    the CLI's overrides on top."""
    from vision_slam_frontend_tpu_torch.frontend import FrontendConfig

    overrides = {}
    if args.max_features is not None:
        overrides["max_features"] = args.max_features
    if args.frame_life is not None:
        overrides["frame_life"] = args.frame_life
    if args.descriptor_family is not None:
        overrides["descriptor_family"] = args.descriptor_family
    if args.validate:
        overrides["validate"] = True
    if args.save_debug:
        overrides["debug_images"] = True
    if args.config:
        return dataclasses.replace(FrontendConfig.load(args.config), **overrides)
    if dataset == "synthetic":
        from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig

        return FrontendConfig(calib=SyntheticRig().calib(), fast_threshold=12.0, **overrides)
    if dataset == "kitti":
        from vision_slam_frontend_tpu_torch.io.kitti import kitti_calib

        return FrontendConfig(calib=kitti_calib(args.input, args.sequence), **overrides)
    if dataset == "euroc":
        from vision_slam_frontend_tpu_torch.io.euroc import euroc_calib

        return FrontendConfig(calib=euroc_calib(args.input), **overrides)
    return FrontendConfig(**overrides)


def make_events(args, dataset: str) -> Iterator[Event]:
    """The run's (kind, timestamp, payload) events, decoded ahead on a
    producer thread unless --no_prefetch or synthetic."""
    if dataset == "synthetic":
        return iter_synthetic(args.input)
    from vision_slam_frontend_tpu_torch.io import image, native_loader

    if args.verbosity > 0:
        if dataset == "bag":
            route = image.decode_route()
            why = native_loader.unavailable_reason()
            print(f"[decode] {route}" + (f" (native libjpeg unavailable: {why})" if why else ""))
        else:
            print(f"[decode] {image.decode_route(native=False)}")
    if dataset == "bag":
        events = iter_bag(args.input, args.left_image_topic, args.right_image_topic, args.odom_topic,
                          args.verbosity)
    elif dataset == "kitti":
        from vision_slam_frontend_tpu_torch.io.kitti import iter_kitti_events

        events = iter_kitti_events(args.input, args.sequence)
    else:
        from vision_slam_frontend_tpu_torch.io.euroc import iter_euroc_events

        events = iter_euroc_events(args.input)
    return events if args.no_prefetch else prefetch_events(events)


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
    p.add_argument("--input", required=True, help="bag file / KITTI or EuRoC directory / synthetic[:N[:step]]")
    p.add_argument("--output", required=True, help="output SLAM problem (.npz)")
    p.add_argument("--dataset", choices=["auto", "bag", "kitti", "euroc", "synthetic"], default="auto")
    p.add_argument("--sequence", default=None, help="KITTI sequence id (e.g. 00)")
    p.add_argument("--config", default=None, help="YAML config/calibration path")
    p.add_argument("--left_image_topic", default="/stereo/left/image_raw/compressed")
    p.add_argument("--right_image_topic", default="/stereo/right/image_raw/compressed")
    p.add_argument("--odom_topic", default="/odometry/filtered")
    p.add_argument(
        "--no_prefetch", action="store_true",
        help="read and decode bag, KITTI and EuRoC frames on the main thread (no decode-ahead thread)",
    )
    p.add_argument(
        "--output_bag", default=None,
        help="also write a reference-format ROS bag (extrinsics/intrinsics/slam_problem topics)",
    )
    p.add_argument("--ply", default=None, help="also export a pose-graph + landmark PLY here")
    p.add_argument("--html", default=None, help="also export a standalone interactive HTML viewer here")
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
    p.add_argument(
        "--visualize", action="store_true",
        help="live visualization: append each keyframe to <output>_live.html, an auto-refreshing "
        "pose-graph and landmark viewer",
    )
    p.add_argument("--visualize_every", type=int, default=1,
                   help="update the live viewer every N keyframes (with --visualize)")
    p.add_argument(
        "--save_debug", action="store_true",
        help="write each keyframe's stereo and match debug images to <output>_debug/ as they are "
        "produced (memory stays flat)",
    )
    p.add_argument("--profile_dir", default=None,
                   help="record a torch.profiler trace of the run into this directory (Chrome trace)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("-v", "--verbosity", type=int, default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dataset = args.dataset if args.dataset != "auto" else detect_dataset(args.input)
    device = resolve_device(args.device)

    from vision_slam_frontend_tpu_torch.frontend import Frontend

    config = make_config(args, dataset)
    events = make_events(args, dataset)
    frontend = Frontend(config, device=device)
    frontend.verbosity = args.verbosity
    base = os.path.splitext(args.output)[0]
    viewer = None
    if args.visualize:
        from vision_slam_frontend_tpu_torch.viz.live import IncrementalLiveViewer

        viewer = IncrementalLiveViewer(base + "_live.html", config.left_cam_to_robot, every=args.visualize_every)
        print(f"Live viewer: open {viewer.path} in a browser (auto-refreshes)")
    if args.save_debug:
        from vision_slam_frontend_tpu_torch.viz.live import DebugImageStreamer

        frontend.debug_sink = DebugImageStreamer(base + "_debug")
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
        return _run(args, dataset, device, config, frontend, events, resume_t, ckpt_path, lambda: interrupted,
                    viewer)
    finally:
        if hasattr(events, "close"):
            events.close()  # stops a decode-ahead thread
        if installed:
            signal.signal(signal.SIGINT, prev_sigint or signal.SIG_DFL)


def _run(args, dataset, device, config, frontend, events, resume_t: float, ckpt_path: str, interrupted,
         viewer=None) -> int:
    """The CLI's event loop and epilogue; `interrupted()` reads the SIGINT
    flag; `viewer` is the live viewer of --visualize. Returns the exit code
    (130 after an interrupt, 1 when the input cannot be read)."""
    from vision_slam_frontend_tpu_torch.io.serialize import save_problem

    try:
        first = next(events, None)
    except (FileNotFoundError, ValueError) as e:
        print(f"Unable to read {args.input}, reason:\n {e}")
        return 1
    if first is None:
        print(f"Unable to read {args.input}, reason:\n no events found")
        return 1
    print(f"Processing {args.input} on {device}")
    prof = start_trace(device) if args.profile_dir else None
    t_start = time.perf_counter()
    frames_seen = 0
    n_poses = last_ckpt_poses = frontend.get_num_poses()
    frame_lat = []  # each stereo frame's host-loop time (s)
    peak_rss_mb = _rss_mb()
    lba_ms = []  # each keyframe's local-BA host time: apply, window build, dispatch
    steady_from = None  # (time, frames, keyframes) when the first local-BA dispatch returned
    local_ba = LocalBAState() if args.local_ba > 0 else None  # this Frontend's in-flight solve
    ba_live = None  # the SLAMProblem whose nodes the in-flight solve updates
    for kind, t, payload in itertools.chain([first], events):
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
        if added and viewer is not None:
            viewer.update(frontend)  # the materialized problem: no pipeline flush
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
    if prof is not None:
        write_trace(prof, args.profile_dir, "slam_frontend_trace.json")
    print("Done processing bag file." if dataset == "bag" else "Done processing input.")

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
    if args.output_bag:
        from vision_slam_frontend_tpu_torch.io.ros_msgs import write_output_bag

        write_output_bag(args.output_bag, problem, config)
        print(f"Wrote reference-format bag {args.output_bag}")
    if args.ply:
        from vision_slam_frontend_tpu_torch.viz.ply import export_ply

        print(f"Wrote {args.ply}: {export_ply(args.ply, problem, config.left_cam_to_robot)}")
    if args.html:
        from vision_slam_frontend_tpu_torch.viz.html import export_html

        print(f"Wrote {args.html}: {export_html(args.html, problem, config.left_cam_to_robot)}")
    if args.save_debug:
        sink = frontend.debug_sink
        print(f"Streamed {sink.num_match} match + {sink.num_stereo} stereo debug images to {sink.directory}/")
    if viewer is not None:
        viewer.update(frontend, force=True)  # the last keyframe's delta
        print(f"Live viewer final state: {viewer.path} ({viewer.last_stats})")
    return 130 if interrupted() else 0  # 130: interrupted, by convention


if __name__ == "__main__":
    sys.exit(main())
