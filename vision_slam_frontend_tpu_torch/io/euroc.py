"""EuRoC MAV dataset loader, ASL format stereo + ground-truth odometry
(port of io/euroc.py).

Layout:
  <root>/mav0/cam0/data/<t_ns>.png + cam0/data.csv + cam0/sensor.yaml
  <root>/mav0/cam1/...  (stereo pair, timestamps aligned)
  <root>/mav0/state_groundtruth_estimate0/data.csv
      (t_ns, p_RS_R xyz, q_RS wxyz, ...) — used as the odometry stream.

sensor.yaml carries radial-tangential distortion and T_BS (sensor-to-body);
the right-camera extrinsic block is derived as T_cam1_cam0.
"""

from __future__ import annotations

import csv
import os
from typing import Iterator

import numpy as np

from vision_slam_frontend_tpu_torch.io.image import load_gray, write_gray


def _read_sensor_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        text = f.read()
    # EuRoC yamls start with "%YAML:1.0", which PyYAML refuses: drop directives.
    return yaml.safe_load("\n".join(ln for ln in text.splitlines() if not ln.startswith("%")))


def _cam_params(cam_dir: str) -> tuple:
    s = _read_sensor_yaml(os.path.join(cam_dir, "sensor.yaml"))
    fu, fv, cu, cv_ = s["intrinsics"]
    dist = list(s.get("distortion_coefficients", [0, 0, 0, 0]))
    k1, k2, p1, p2 = (dist + [0, 0, 0, 0])[:4]
    T = np.array(s["T_BS"]["data"], np.float64).reshape(4, 4)
    intr = dict(fx=fu, fy=fv, cx=cu, cy=cv_, k1=k1, k2=k2, p1=p1, p2=p2, k3=0.0)
    return intr, T


def euroc_calib(path: str) -> dict:
    mav = os.path.join(path, "mav0")
    intr0, T_B_c0 = _cam_params(os.path.join(mav, "cam0"))
    intr1, T_B_c1 = _cam_params(os.path.join(mav, "cam1"))
    # x_cam1 = T_c1_B @ T_B_c0 @ x_cam0
    T_c1_c0 = np.linalg.inv(T_B_c1) @ T_B_c0
    return {
        "intrinsics_left": intr0,
        "intrinsics_right": intr1,
        "right_extrinsic": T_c1_c0[:3, :].tolist(),
        "left_cam_to_robot_translation": T_B_c0[:3, 3].tolist(),
        "left_cam_to_robot_rotation": T_B_c0[:3, :3].tolist(),
    }


def _read_cam_csv(cam_dir: str) -> dict:
    """timestamp_ns -> filename."""
    out = {}
    with open(os.path.join(cam_dir, "data.csv")) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            out[int(row[0])] = row[1].strip()
    return out


def iter_euroc_events(path: str) -> Iterator[tuple]:
    """Yield time-ordered ("odometry"/"stereo", t_seconds, payload) events."""
    mav = os.path.join(path, "mav0")
    cam0 = os.path.join(mav, "cam0")
    cam1 = os.path.join(mav, "cam1")
    files0 = _read_cam_csv(cam0)
    files1 = _read_cam_csv(cam1)
    stereo_ts = sorted(set(files0) & set(files1))

    gt_path = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
    odom = []
    with open(gt_path) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            t_ns = int(row[0])
            p = np.array([float(row[1]), float(row[2]), float(row[3])])
            q = np.array([float(row[4]), float(row[5]), float(row[6]), float(row[7])])  # w,x,y,z
            odom.append((t_ns, p, q))

    events = [("odometry", t_ns, (p, q)) for t_ns, p, q in odom]
    events += [("stereo", t_ns, t_ns) for t_ns in stereo_ts]
    events.sort(key=lambda e: (e[1], 0 if e[0] == "odometry" else 1))
    for kind, t_ns, payload in events:
        if kind == "odometry":
            p, q = payload
            yield ("odometry", t_ns * 1e-9, (p, q))
        else:
            left = load_gray(os.path.join(cam0, "data", files0[payload]))
            right = load_gray(os.path.join(cam1, "data", files1[payload]))
            yield ("stereo", t_ns * 1e-9, (left, right))


def write_directory(root: str, frames, rig) -> None:
    """An EuRoC directory of rendered stereo frames (io/synthetic.py):
    cam0/cam1 PNGs with data.csv, a sensor.yaml each (a `%YAML:1.0`
    directive, comments, T_BS's flow list over two lines) and the odometry
    as state_groundtruth_estimate0. For tests and the GPU smoke test."""
    mav = os.path.join(root, "mav0")
    right = np.eye(4)
    right[0, 3] = rig.baseline
    for cam, side, T in (("cam0", "left", np.eye(4)), ("cam1", "right", right)):
        d = os.path.join(mav, cam, "data")
        os.makedirs(d)
        rows = []
        for f in frames:
            name = f"{int(f.timestamp * 1e9) + 1}.png"
            write_gray(os.path.join(d, name), getattr(f, side))
            rows.append(f"{int(f.timestamp * 1e9) + 1},{name}")
        with open(os.path.join(mav, cam, "data.csv"), "w") as fh:
            fh.write("#t,name\n" + "\n".join(rows) + "\n")
        data = [repr(float(v)) for v in T.ravel()]
        with open(os.path.join(mav, cam, "sensor.yaml"), "w") as fh:
            fh.write(f"%YAML:1.0\n# {cam}\nintrinsics: [{rig.fx}, {rig.fy}, {rig.cx}, {rig.cy}] # fu, fv, cu, cv\n"
                     "distortion_coefficients: [0.0, 0.0, 0.0, 0.0]\n"
                     f"T_BS:\n  cols: 4\n  rows: 4\n  data: [{', '.join(data[:8])},\n         {', '.join(data[8:])}]\n")
    gt = os.path.join(mav, "state_groundtruth_estimate0")
    os.makedirs(gt)
    rows = [f"{int(f.timestamp * 1e9)},{','.join(str(v) for v in f.odom_translation)},"
            f"{','.join(str(v) for v in f.odom_rotation)}" for f in frames]
    with open(os.path.join(gt, "data.csv"), "w") as fh:
        fh.write("#gt\n" + "\n".join(rows) + "\n")
