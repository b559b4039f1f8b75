"""The loop written in set-up as an EuRoC ASL directory under TMPDIR (PNG
pairs, sensor.yaml, ground truth at the odometry rate), read lap after lap
through the port's iter_euroc_events behind its prefetch_events, as the
frontend CLI reads it. Each pair's read and decode on the prefetch thread is
an `io.decode` span."""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from slam_bench.common import Spans


def write_euroc(root: str, frames, config: dict, stream, T_b1) -> None:
    """One lap as an EuRoC ASL directory (cv2 PNG, sensor.yaml, ground truth)."""
    import cv2

    cam = config["camera"]
    mav = os.path.join(root, "mav0")
    pool = ThreadPoolExecutor(max_workers=8)
    jobs = []
    for c, side, T in (("cam0", "left", np.asarray(cam["body_from_left_camera"], np.float64)), ("cam1", "right", T_b1)):
        d = os.path.join(mav, c, "data")
        os.makedirs(d)
        rows = []
        for i, pair in enumerate(frames):
            name = f"{stream.frame_ns(i)}.png"
            jobs.append((name, pool.submit(cv2.imwrite, os.path.join(d, name), pair[0 if side == "left" else 1])))
            rows.append(f"{stream.frame_ns(i)},{name}")
        with open(os.path.join(mav, c, "data.csv"), "w") as fh:
            fh.write("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
        intr = cam[side]
        data = [repr(float(v)) for v in T.ravel()]
        with open(os.path.join(mav, c, "sensor.yaml"), "w") as fh:
            fh.write(
                f"%YAML:1.0\n# {c}\nintrinsics: [{intr['fx']!r}, {intr['fy']!r}, {intr['cx']!r}, {intr['cy']!r}]"
                " # fu, fv, cu, cv\n"
                f"distortion_coefficients: [{intr['k1']!r}, {intr['k2']!r}, {intr['p1']!r}, {intr['p2']!r}]\n"
                f"T_BS:\n  cols: 4\n  rows: 4\n  data: [{', '.join(data[:8])},\n         {', '.join(data[8:])}]\n")
    gt = os.path.join(mav, "state_groundtruth_estimate0")
    os.makedirs(gt)
    rows = [f"{j * stream._odom_ns()},{','.join(repr(float(v)) for v in t)},{','.join(repr(float(v)) for v in q)}"
            for j, (t, q) in enumerate(stream.poses)]
    with open(os.path.join(gt, "data.csv"), "w") as fh:
        fh.write("#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z\n" + "\n".join(rows) + "\n")
    pool.shutdown(wait=True)
    for name, job in jobs:
        if not job.result():
            raise RuntimeError(f"cv2.imwrite failed for {name}")


def _euroc_laps(root: str, lap_s: float, spans: Spans):
    """iter_euroc_events over the directory lap after lap, each lap's times
    moved on by `lap_s`; runs on the prefetch thread, where each stereo
    pair's read and decode is an `io.decode` span."""
    from vision_slam_frontend_tpu_torch.io.euroc import iter_euroc_events

    lap = 0
    while True:
        it = iter_euroc_events(root)
        while True:
            t0 = time.perf_counter()
            try:
                kind, t, payload = next(it)
            except StopIteration:
                break
            if kind == "stereo" and spans.on:
                spans.items.append(("io.decode", threading.get_ident(), t0, time.perf_counter()))
            yield kind, t + lap * lap_s, payload
        lap += 1


def start(ctx: dict) -> dict:
    from vision_slam_frontend_tpu_torch.cli.slam_frontend import prefetch_events
    from vision_slam_frontend_tpu_torch.io.euroc import euroc_calib

    stream = ctx["stream"]
    tmp = tempfile.mkdtemp(prefix="slam_bench_euroc_")
    write_euroc(tmp, ctx["frames"], ctx["config"], stream, ctx["T_b1"])
    events = prefetch_events(_euroc_laps(tmp, stream.lap_ns * 1e-9, ctx["spans"]))

    def close():
        events.close()
        for th in threading.enumerate():
            if th.name == "vsf-prefetch":
                th.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)

    return dict(calib=euroc_calib(tmp), events=events, close=close)
