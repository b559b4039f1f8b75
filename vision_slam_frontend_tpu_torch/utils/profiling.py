"""Per-stage wall-clock profiling of the keyframe step (port of
utils/profiling.py): the quick "where does the keyframe millisecond go"
answer without a trace viewer; `slam_frontend --profile_dir` records a full
torch.profiler trace instead.

Each stage is the port's own op, timed alone on the data it sees inside the
ORB step (as the JAX package's function does, whatever the config's
family). The stage sum exceeds the step's time, since a stage timed alone
pays its own launches and syncs; the whole step is timed too. On CUDA the
result also holds the step's enqueue time (`_fused_step_enqueue_ms`): the
step is launch-bound, so the host time to enqueue it against the synced
time is the reading that matters.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch


def _best_of(dispatch: Callable[[], object], sync: Callable[[], None], iters: int,
             windows: int) -> tuple[float, float]:
    """(synced, enqueue) best-of-windows seconds per call: each window
    queues `iters` dispatches and syncs once; `enqueue` is the window's
    time before that sync."""
    best, best_enqueue = float("inf"), float("inf")
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            dispatch()
        t1 = time.perf_counter()
        sync()
        t2 = time.perf_counter()
        best = min(best, (t2 - t0) / iters)
        best_enqueue = min(best_enqueue, (t1 - t0) / iters)
    return best, best_enqueue


def profile_keyframe_stages(config=None, image_shape=(480, 640), iters: int = 10, windows: int = 3,
                            device="cuda") -> dict:
    """Time each stage alone and the whole step on `device`.

    Returns {stage: milliseconds}, plus "_stage_sum_ms" and "_fused_step_ms"
    (and "_fused_step_enqueue_ms" on CUDA)."""
    from vision_slam_frontend_tpu_torch.frontend.config import FrontendConfig
    from vision_slam_frontend_tpu_torch.frontend.keyframe import StepParams, WindowState, keyframe_step
    from vision_slam_frontend_tpu_torch.geometry.camera import (
        epipolar_residual,
        triangulate_points,
        undistort_points,
    )
    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig, generate_sequence
    from vision_slam_frontend_tpu_torch.ops.brief import detect_and_describe, unpack_bits
    from vision_slam_frontend_tpu_torch.ops.fast import fast_scores
    from vision_slam_frontend_tpu_torch.ops.hamming import best_percent_mask, match_window, ratio_test_match

    device = torch.device(device)
    rig = SyntheticRig(width=image_shape[1], height=image_shape[0])
    if config is None:
        config = FrontendConfig(calib=rig.calib(), fast_threshold=12.0)
    K, W = config.max_features, config.frame_life
    params = StepParams.from_config(config, device)

    frame = next(iter(generate_sequence(num_frames=2, step=0.25, rig=rig)))
    left, right = (torch.from_numpy(np.clip(im, 0, 255).astype(np.uint8)).to(device)
                   for im in (frame.left, frame.right))

    def detect(img):
        return detect_and_describe(img, threshold=params.fast_threshold, max_keypoints=K,
                                   border=config.detect_border, blur_sigma=config.blur_sigma,
                                   num_levels=config.num_levels, scale_factor=config.pyramid_scale)

    l_kps, _, l_desc, l_valid = detect(left)
    r_kps, _, r_desc, r_valid = detect(right)
    r_idx, _, s_matched = ratio_test_match(l_desc, l_valid, r_desc, r_valid, params.nn_match_ratio)
    matched_r = r_kps[r_idx.long()]

    # A warmed window state, as it looks mid-sequence.
    state = WindowState.create(W, K, config.stereo_threshold_init, device, words=l_desc.shape[1])
    state = dataclasses.replace(
        state, desc=l_desc.expand((W,) + l_desc.shape).contiguous(),
        valid=l_valid.expand((W,) + l_valid.shape).contiguous(),
        count=torch.tensor(W, dtype=torch.int32, device=device),
    )

    def window():
        return match_window(state.desc, state.valid, l_desc, l_valid, params.nn_match_ratio, params.best_percent)

    lu = undistort_points(params.intr_left, l_kps)
    ru = undistort_points(params.intr_right, matched_r)
    _, wd_raw, wm_raw = window()
    smap = fast_scores(left)
    desc_rows = state.desc.reshape(W * K, -1)
    reverse = torch.flip(torch.arange(K, device=device), [0])

    stages = {
        "detect_describe_x2": lambda: detect(left)[2] + detect(right)[2],
        "stereo_ratio_match": lambda: ratio_test_match(l_desc, l_valid, r_desc, r_valid, params.nn_match_ratio)[1],
        "epipolar_filter": lambda: epipolar_residual(params.fundamental, l_kps, matched_r),
        "window_match": lambda: window()[1],
        "undistort_x2": lambda: undistort_points(params.intr_left, l_kps)
        + undistort_points(params.intr_right, matched_r),
        "triangulate": lambda: triangulate_points(params.P_left, params.P_right, lu, ru),
        # Sub-stages: where inside detect and match the time goes.
        "  detect: fast_scores": lambda: fast_scores(left),
        "  detect: top_k": lambda: torch.sort(smap.reshape(-1), descending=True, stable=True)[0][:K],
        "  match: unpack_window": lambda: unpack_bits(desc_rows),
        "  match: best_percent": lambda: best_percent_mask(wd_raw, wm_raw, params.best_percent),
        "  step: stable_partition": lambda: torch.argsort(torch.where(s_matched, 0, 1), stable=True),
        "  step: gather_compact": lambda: l_desc[reverse],
    }

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    out = {}
    for name, fn in stages.items():
        fn()  # warm: kernel builds, allocator
        sync()
        out[name] = _best_of(fn, sync, iters, windows)[0] * 1e3

    st = WindowState.create(W, K, config.stereo_threshold_init, device, words=l_desc.shape[1])

    def run_fused():
        nonlocal st
        st, res = keyframe_step(params, st, left, right, 1, capacity=K, window=W, border=config.detect_border,
                                blur_sigma=config.blur_sigma, num_levels=config.num_levels,
                                scale_factor=config.pyramid_scale)
        return res.num_features

    run_fused()
    sync()
    out["_stage_sum_ms"] = sum(v for k, v in out.items() if not k.startswith("_"))
    fused, enqueue = _best_of(run_fused, sync, iters, windows)
    out["_fused_step_ms"] = fused * 1e3
    if device.type == "cuda":
        out["_fused_step_enqueue_ms"] = enqueue * 1e3
    return out


def format_stage_table(timings: dict) -> str:
    rows = [(k, v) for k, v in timings.items() if not k.startswith("_")]
    rows.sort(key=lambda kv: -kv[1])
    total = timings.get("_stage_sum_ms", sum(v for _, v in rows))
    lines = [f"{'stage':<22} {'ms':>8}  {'% of sum':>8}"]
    for k, v in rows:
        lines.append(f"{k:<22} {v:8.3f}  {100.0 * v / max(total, 1e-9):7.1f}%")
    lines.append(f"{'stage sum':<22} {total:8.3f}")
    if "_fused_step_ms" in timings:
        lines.append(f"{'fused keyframe step':<22} {timings['_fused_step_ms']:8.3f}  (one step, synced)")
    if "_fused_step_enqueue_ms" in timings:
        lines.append(f"{'  of which enqueue':<22} {timings['_fused_step_enqueue_ms']:8.3f}  (host time to launch it)")
    return "\n".join(lines)


def start_trace(device):
    """A running torch.profiler recording CPU and, on a GPU, CUDA activity."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def write_trace(prof, directory: str, name: str) -> str:
    """Stop `prof` (after the device's queued work) and write its Chrome
    trace to `directory`/`name`; returns the path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    prof.export_chrome_trace(path)
    print(f"Wrote profiler trace to {directory}")
    return path
