"""Offline replay of a stereo log through the port's Frontend: frames/s,
keyframe latency, and the comparison of every keyframe with the reference.

The traffic file's `input` names the file slam_bench/inputs/<input>.py that
turns the rendered loop into the program's events (frames in memory, an
EuRoC directory of PNGs, ...); a new input is a new file there. Its
`start(ctx)` returns {"calib", "events", "close"}: the frontend's calib dict,
an iterator of (kind, t, payload) events in the order the program receives
them (a stereo payload is the (left, right) pair; a fourth element, when
present, is the host time the frame arrived, from which its latency counts),
and a callable that stops whatever the input started.
"""

from __future__ import annotations

import gc
import math
import threading
import time

import numpy as np

from slam_bench import devtrace, scene
from slam_bench.common import Spans, load_module, p95
from slam_bench.reference import compare_frontend, frontend_ref, local_ba_ref


def rig_calib(config: dict) -> dict:
    """The frontend's calib dict from the configuration: the right camera is
    the left one moved by the baseline along its x axis."""
    cam = config["camera"]
    T_b0 = np.asarray(cam["body_from_left_camera"], np.float64)
    T_01 = np.eye(4)
    T_01[0, 3] = cam["baseline_m"]
    T_b1 = T_b0 @ T_01
    T_10 = np.linalg.inv(T_b1) @ T_b0
    return {
        "intrinsics_left": dict(cam["left"]),
        "intrinsics_right": dict(cam["right"]),
        "right_extrinsic": T_10[:3, :].tolist(),
        "left_cam_to_robot_translation": T_b0[:3, 3].tolist(),
        "left_cam_to_robot_rotation": T_b0[:3, :3].tolist(),
    }, T_b1


def frontend_settings(config: dict) -> dict:
    fe = config["frontend"]
    return dict(
        max_features=config["ORBextractor.nFeatures"], num_levels=config["ORBextractor.nLevels"],
        pyramid_scale=config["ORBextractor.scaleFactor"], fast_threshold=float(config["ORBextractor.iniThFAST"]),
        frame_life=fe["frame_life"], nn_match_ratio=fe["nn_match_ratio"], best_percent=fe["best_percent"],
        mutual_check=fe["mutual_check"], guided_match_radius=fe["guided_match_radius"],
        min_odom_translation=fe["min_odom_translation"],
        min_odom_rotation=fe["min_odom_rotation_deg"] * np.pi / 180.0,
        blur_sigma=fe["blur_sigma"], detect_border=fe["detect_border"], descriptor_family=fe["descriptor_family"],
    )


class Stream:
    """The loop's timestamps and poses: frame g shows loop frame g mod N at
    t = g / rate; odometry is sampled at the configuration's odometry rate.
    With the traffic's `odom_drift_m`, the odometry's translation carries a
    random walk of that many metres a frame (the images stay true), drawn
    from the seed."""

    def __init__(self, config: dict, traffic: dict, seed: int = 0):
        self.drift_m = traffic.get("odom_drift_m", 0.0)
        self.rng = np.random.default_rng([seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, 7])
        self.drift = np.zeros((1, 3))
        self.n = traffic["loop_frames"]
        self.rate = config["camera"]["rate_hz"]
        self.per = int(round(config["camera"].get("odometry_rate_hz", self.rate) / self.rate))
        self.poses = [scene.body_pose(traffic, config["camera"], 2.0 * math.pi * j / (self.n * self.per))
                      for j in range(self.n * self.per)]
        self.lap_ns = self.n * self.per * self._odom_ns()

    def _drift(self, j: int) -> np.ndarray:
        """The odometry's accumulated translation error at sample j."""
        while self.drift.shape[0] <= j:
            steps = self.rng.normal(0.0, self.drift_m / np.sqrt(self.per), (4096, 3))
            self.drift = np.concatenate([self.drift, self.drift[-1] + np.cumsum(steps, 0)])
        return self.drift[j]

    def _odom_ns(self) -> int:
        return int(round(1e9 / (self.rate * self.per)))

    def frame_ns(self, i: int) -> int:
        return i * self.per * self._odom_ns()

    def events(self, frames: int):
        """The (kind, t, payload) events up to frame `frames` - 1, in the
        order the program receives them; a stereo payload is its loop
        frame index."""
        lap_s = self.lap_ns * 1e-9
        n_odom = self.n * self.per
        for g in range(frames):
            lap, i = divmod(g, self.n)
            for j in range(i * self.per - (self.per - 1 if g else 0), i * self.per + 1):
                o_lap, o_j = (lap - 1, j + n_odom) if j < 0 else (lap, j)
                pose = self.poses[o_j]
                if self.drift_m:
                    pose = (pose[0] + self._drift(o_lap * n_odom + o_j), pose[1])
                yield ("odometry", (o_j * self._odom_ns()) * 1e-9 + o_lap * lap_s, pose)
            yield ("stereo", self.frame_ns(i) * 1e-9 + lap * lap_s, i)


def run(cell: dict, seed: int, seconds: float, trace: bool, t_process0: float, device: str = "cuda") -> dict:
    """One run of a frontend cell. Returns the pieces of the result line."""
    import torch

    from vision_slam_frontend_tpu_torch.frontend import Frontend, FrontendConfig

    config, traffic = cell["config"], cell["traffic"]
    on_card = device == "cuda"
    spans = Spans(trace)
    settings = frontend_settings(config)
    calib, T_b1 = rig_calib(config)
    stream = Stream(config, traffic, seed)

    # --- set-up: render the loop on the device, hand it over as the input.
    t_setup0 = time.perf_counter()
    renderer = scene.Renderer(config, traffic, seed, device)
    frames = renderer.loop_frames()
    del renderer
    t_rendered = time.perf_counter()
    source = load_module(cell["bench_dir"], "inputs", traffic["input"]).start(
        dict(config=config, traffic=traffic, frames=frames, stream=stream, calib=calib, T_b1=T_b1, spans=spans))
    fe_cfg = FrontendConfig(calib=source["calib"], **settings)
    events = source["events"]
    t_written = time.perf_counter()
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    frontend = Frontend(fe_cfg, device=device)

    lba_window = traffic.get("local_ba_window", 0)
    lba_state = ba_live = None
    if lba_window:
        from vision_slam_frontend_tpu_torch.backend.local_ba import LocalBAState, windowed_local_ba

        lba_state = LocalBAState()
    n_frames = 0
    t_hand, t_mat = [], []
    sample_rng = np.random.default_rng(seed & 0xFFFFFFFF)
    decoded = {}
    decode_every = traffic.get("decode_sample_every", 0)
    main = threading.get_ident()
    t_start = t_end = t_window = None
    slice_ = slice_rec = None
    slice_info = {}
    warm = traffic["warmup_keyframes"]
    try:
        for kind, t, payload, *arrived in events:
            if kind == "odometry":
                frontend.observe_odometry(payload[0], payload[1], t)
                continue
            g = n_frames
            n_frames += 1
            if decode_every and t_start is not None and sample_rng.random() < 1.0 / decode_every:
                decoded[g] = payload
            th = time.perf_counter()
            added = frontend.observe_image(payload[0], payload[1], t)
            tc = time.perf_counter()
            if added:
                t_hand.append(arrived[0] if arrived else th)
            if spans.on:
                spans.items.append(("frontend.observe_image" + (".keyframe" if added else ".gated"), main, th, tc))
            if added and lba_state is not None and len(t_hand) >= 4:
                # The frontend CLI's order: apply keyframe k-1's solve, then
                # dispatch this keyframe's window.
                with spans.span("local_ba"):
                    updated, _ = lba_state.flush()
                    if updated and ba_live is not None:
                        frontend.update_poses(ba_live.nodes)
                    ba_live = frontend.get_slam_problem()
                    windowed_local_ba(ba_live, fe_cfg, window=lba_window, pipeline=True, state=lba_state,
                                      device=device)
                tc = time.perf_counter()
            n_mat = len(frontend.peek_accumulated()[0])
            while len(t_mat) < n_mat:
                t_mat.append(tc)
            if t_start is None:
                if len(t_hand) >= warm:
                    if on_card:
                        torch.cuda.synchronize()
                    # Set-up's objects (imports, the input) leave the
                    # collector's scans: the window's collections see the
                    # program's own objects.
                    gc.collect()
                    gc.freeze()
                    t_start = time.perf_counter()
                    frames_at_start, kf_at_start = n_frames, len(t_hand)
                continue
            if t_window is None and time.perf_counter() - t_start >= seconds:
                t_window = time.perf_counter()
                if not (trace and on_card):
                    break
                # The profiled slice follows the window: its start, stop and
                # export hold up no frame that the window times.
                slice_ = devtrace.Slice()
                slice_info = dict(kf0=len(t_hand), frame0=n_frames, t0=slice_.host0)
            elif slice_ is not None and len(t_hand) - slice_info["kf0"] >= traffic["trace_keyframes"]:
                slice_info.update(kf1=len(t_hand), frame1=n_frames, t1=time.perf_counter())
                slice_info["keyframes"] = list(range(slice_info["kf0"], slice_info["kf1"]))
                slice_rec = slice_.close()
                slice_ = None
                break
        n_kf = frontend.get_num_poses()  # materializes the last keyframe
        if lba_state is not None:
            updated, _ = lba_state.flush()
            if updated and ba_live is not None:
                frontend.update_poses(ba_live.nodes)
        t_end = time.perf_counter()
        while len(t_mat) < n_kf:
            t_mat.append(t_end)
        if slice_rec is not None:
            t_end = t_window
    finally:
        source["close"]()

    setup_s = t_start - t_process0
    window_s = t_end - t_start
    frames_in = n_frames - frames_at_start
    lat = [(t_mat[k] - t_hand[k]) * 1e3 for k in range(kf_at_start, len(t_hand))]
    quarters = np.histogram([t_hand[k] - t_start for k in range(kf_at_start, len(t_hand))], bins=4,
                            range=(0.0, window_s))[0].tolist()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    # --- the program's outputs, then its state freed before the reference.
    problem = frontend.get_slam_problem()
    prog_nodes = compare_frontend.program_nodes(problem, frontend.node_track_ids)
    prog_matches = compare_frontend.program_matches(problem)
    st = frontend._state
    prog_window = (st.desc.cpu().numpy(), st.valid.cpu().numpy(), st.frame_id.cpu().numpy())
    del frontend, problem, st
    if on_card:
        torch.cuda.empty_cache()

    ref_cfg = dict(settings)
    ref = frontend_ref.ReferenceFrontend(ref_cfg, calib, device)
    ref_kfs = ref.keyframes(Stream(config, traffic, seed).events(n_frames))
    record = set(slice_info.get("keyframes", []))
    t_ref = time.perf_counter()
    ref_results, ref_win = ref.run(ref_kfs, lambda i: frames[i], batch=traffic.get("reference_batch", 8),
                                   record_levels=record if trace else None)
    ref_window = (ref_win.desc.cpu().numpy(), ref_win.valid.cpu().numpy(), ref_win.frame_id.cpu().numpy())
    numbers = compare_frontend.compare(prog_nodes, prog_matches, ref_kfs, ref_results,
                                       settings["max_features"], settings["frame_life"], prog_window, ref_window,
                                       poses=not lba_window)
    if lba_window:
        ref_nodes = [dict(loc=kf["loc"], angle=kf["angle"], pixels=r["pixels"], right=r["right"], points=r["points"])
                     for kf, r in zip(ref_kfs, ref_results)]
        ref_matches = compare_frontend.reference_matches(ref_results)
        local_ba_ref.run(ref_nodes, [ref_matches[k] for k in range(len(ref_nodes))],
                         [kf.get("odom") for kf in ref_kfs], calib, device, window=lba_window)
        n = min(len(ref_nodes), len(prog_nodes))
        numbers["local_ba_pose_gap_m"] = max(
            (float(np.abs(prog_nodes[k]["loc"] - ref_nodes[k]["loc"]).max()) for k in range(n)), default=0.0)
        numbers["local_ba_rotation_gap"] = max(
            (float(1.0 - abs(np.dot(prog_nodes[k]["angle"], ref_nodes[k]["angle"].astype(np.float64))))
             for k in range(n)), default=0.0)
    if decode_every:
        numbers["decode_mismatch_px"] = float(sum(
            int((np.clip(l, 0, 255).astype(np.uint8) != frames[g % stream.n][0]).sum())
            + int((np.clip(r, 0, 255).astype(np.uint8) != frames[g % stream.n][1]).sum())
            for g, (l, r) in decoded.items()))
    ref_s = time.perf_counter() - t_ref
    fill = float(np.mean([n["pixels"].shape[0] for n in prog_nodes])) / settings["max_features"]
    det_fill = float(np.mean([r["n_left_valid"] for r in ref_results])) / settings["max_features"]
    notes = [
        f"keyframe_latency_p95_ms {p95(lat) if lat else float('nan')!r} over {len(lat)} keyframes; "
        f"{frames_in} frames in {window_s:.3f} s; "
        f"latency ms median {float(np.median(lat)) if lat else float('nan'):.1f}, max {max(lat, default=float('nan')):.1f}",
        f"fill: {fill:.4f} of K={settings['max_features']} as node features a keyframe, "
        f"{det_fill:.4f} as detections a left image; {len(prog_nodes)} keyframes, {n_frames} frames in all",
        f"reference: {len(ref_kfs)} keyframes in {ref_s:.2f} s; decoded frames sampled: {len(decoded)}",
        f"keyframes handed in each quarter of the window: {quarters}; load {open('/proc/loadavg').read().split()[:3]}",
        f"set-up: {t_setup0 - t_process0:.2f} s imports and start, {t_rendered - t_setup0:.2f} s rendering, "
        f"{t_written - t_rendered:.2f} s writing the input, {t_start - t_written:.2f} s warm-up "
        f"({warm} keyframes, {frames_at_start} frames)",
    ]
    e2e = {"frames_per_s": frames_in / window_s, "setup_s": setup_s}
    if lat:
        e2e["keyframe_latency_p95_ms"] = p95(lat)
    if lba_window:
        e2e.pop("keyframe_latency_p95_ms", None)
    ctx = dict(kind="frontend", spans=spans, main_thread=main, slice=slice_rec, slice_info=slice_info,
               t_start=t_start, t_end=t_end, settings=settings, ref_results=ref_results,
               image_shape=frames[0][0].shape, window_s=window_s)
    return dict(e2e=e2e, numbers=numbers, attempted=frames_in, failed=0, peak=peak, ctx=ctx, notes=notes)
