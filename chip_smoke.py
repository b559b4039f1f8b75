#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure ends the run with a non-zero exit:
  1. device   a CUDA device is required (no CPU path); its name and
              `nvidia-smi` name/power limit
  2. build    nvcc builds the three kernels from csrc/ (sm_90a)
  3. kernels  each kernel against its plain PyTorch version on the card, on
              the same inputs at the main path's shapes: exact equality
  4. parity   keyframe_step on CUDA vs on the CPU from the same state, for 4
              synthetic keyframes: every int and bool field equal
  5. main     the port's CLI on synthetic:20 on the card: launch counts from
              that run, output checked against the CPU run of the same input,
              then one steady-state step under sync-debug mode "error"
  6. timing   median keyframe step time, and each kernel beside its plain
              version (CUDA events, median of 30 launches)
Then the kernels JSON line and, last, the result line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

NUM_PARITY_KEYFRAMES = 4
MAIN_INPUT = "synthetic:20"
TIMING_KEYFRAMES = 20
TIMING_RUNS = 30

# Kernel name -> (CUDA source, the TPU kernel it replaces).
KERNELS = {
    "fast_scores_nms": (
        "vision_slam_frontend_tpu_torch/csrc/fast_nms.cu",
        "vision_slam_frontend_tpu/ops/pallas_kernels.py:331",
    ),
    "extract_patches": (
        "vision_slam_frontend_tpu_torch/csrc/extract_patches.cu",
        "vision_slam_frontend_tpu/ops/pallas_kernels.py:394",
    ),
    "hamming_top2": (
        "vision_slam_frontend_tpu_torch/csrc/hamming_top2.cu",
        "vision_slam_frontend_tpu/ops/pallas_kernels.py:193",
    ),
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def check_equal(what: str, a, b) -> None:
    """Exact equality (equal infinities and NaNs included), or a failure
    that names how many elements differ and the first of them."""
    import torch

    a, b = a.cpu(), b.cpu()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.dtype.is_floating_point else a == b
    if a.shape != b.shape or not bool(same.all()):
        if a.shape != b.shape:
            raise AssertionError(f"{what}: shapes {tuple(a.shape)} vs {tuple(b.shape)}")
        first = tuple((~same).nonzero()[0].tolist())
        raise AssertionError(
            f"{what}: {int((~same).sum())} of {a.numel()} elements differ; first at {first}: "
            f"{a[first].item()} vs {b[first].item()}"
        )


def max_abs_err(a, b) -> float:
    """Largest |a - b|, with equal infinities counting as 0."""
    import torch

    a = a.double()
    b = b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def synthetic_frames(n: int):
    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig, generate_sequence

    return list(generate_sequence(num_frames=n, step=0.25, rig=SyntheticRig()))


def frame_poses(frames):
    """Per-frame odometry world pose relative to frame 0 (the Frontend's rule)."""
    from vision_slam_frontend_tpu_torch.utils import np_geom

    q0 = np_geom.quat_normalize(np.asarray(frames[0].odom_rotation, np.float64))
    t0 = np.asarray(frames[0].odom_translation, np.float64)
    q0_inv = np_geom.quat_inverse(q0)
    out = []
    for f in frames:
        q = np_geom.quat_normalize(np.asarray(f.odom_rotation, np.float64))
        t = np_geom.quat_rotate(q0_inv, np.asarray(f.odom_translation, np.float64) - t0)
        out.append((t.astype(np.float32), np_geom.quat_multiply(q, q0_inv).astype(np.float32)))
    return out


def u8(img: np.ndarray) -> np.ndarray:
    return np.clip(img, 0, 255).astype(np.uint8)


def cuda_ms(fn, runs: int = TIMING_RUNS) -> float:
    """Median device time of one call of `fn`, by CUDA events, after warm-up."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels(ck, frames, dev):
    """Each kernel vs its plain version on the card; returns max errors."""
    import torch

    from vision_slam_frontend_tpu_torch.ops.fast import fast_detect
    from vision_slam_frontend_tpu_torch.ops.image import gaussian_blur

    errs = {}
    # B1: two rendered 640x480 frames.
    e = 0.0
    for f in frames[:2]:
        img = torch.from_numpy(u8(f.left)).to(dev)
        raw, sup = ck.fast_scores_nms(img)
        torch.cuda.synchronize()
        raw_p, sup_p = ck.fast_scores_nms_plain(img)
        check_equal("fast_scores_nms raw vs plain", raw, raw_p)
        check_equal("fast_scores_nms suppressed vs plain", sup, sup_p)
        e = max(e, max_abs_err(raw, raw_p), max_abs_err(sup, sup_p))
    errs["fast_scores_nms"] = e

    # B2: K=512, C=1, ps=31 f16 (the ORB path) with clamped corners and
    # exact .5 coordinates, plus a 2-plane f32 case.
    img = torch.from_numpy(u8(frames[0].left)).to(dev)
    kps, _, _ = fast_detect(img, threshold=12.0, max_keypoints=512, border=19)
    special = torch.tensor(
        [[0.0, 0.0], [639.0, 479.0], [-7.0, 3.0], [700.0, 500.0], [100.5, 200.5],
         [101.5, 33.5], [15.5, 15.5], [624.5, 464.5], [320.49, 240.51], [2.5, 477.5]],
        device=dev,
    )
    kps = torch.cat([kps[: 512 - len(special)], special]).contiguous()
    planes = gaussian_blur(img.float()).to(torch.float16)[None].contiguous()
    e = 0.0
    for p in (planes, torch.cat([planes, planes * 0.5]).float().contiguous()):
        out = ck.extract_patches(p, kps, 31)
        torch.cuda.synchronize()
        ref = ck.extract_patches_plain(p, kps, 31)
        check_equal(f"extract_patches {p.dtype} vs plain", out, ref)
        e = max(e, max_abs_err(out, ref))
    errs["extract_patches"] = e

    # B3: stereo 512x512 and window 5120x512 at 8 words, 2048x2048 at 16
    # words, invalid trains, and one all-invalid train set.
    rng = np.random.default_rng(0)
    e = 0.0
    for kq, kt, words, invalid in ((512, 512, 8, 0.3), (5120, 512, 8, 0.3),
                                   (2048, 2048, 16, 0.2), (512, 512, 8, 1.0), (77, 300, 8, 0.5)):
        q = torch.from_numpy(rng.integers(0, 2**32, (kq, words), dtype=np.uint32).view(np.int32)).to(dev)
        t = torch.from_numpy(rng.integers(0, 2**32, (kt, words), dtype=np.uint32).view(np.int32)).to(dev)
        v = torch.from_numpy(rng.random(kt) >= invalid).to(dev)
        idx, d1, d2 = ck.hamming_top2(q, t, v)
        torch.cuda.synchronize()
        idx_p, d1_p, d2_p = ck.hamming_top2_plain(q, t, v)
        case = f"hamming_top2 {kq}x{kt} words={words} invalid={invalid}"
        check_equal(f"{case} idx vs plain", idx, idx_p)
        check_equal(f"{case} d1 vs plain", d1, d1_p)
        check_equal(f"{case} d2 vs plain", d2, d2_p)
        e = max(e, max_abs_err(d1, d1_p), max_abs_err(d2, d2_p), max_abs_err(idx, idx_p))
    errs["hamming_top2"] = e
    return errs


def step_inputs(frames, dev):
    import torch

    poses = frame_poses(frames)
    return [
        (
            torch.from_numpy(u8(f.left)).to(dev),
            torch.from_numpy(u8(f.right)).to(dev),
            torch.from_numpy(t).to(dev),
            torch.from_numpy(q).to(dev),
        )
        for f, (t, q) in zip(frames, poses)
    ]


def run_step(params, state, inputs, fid, config):
    from vision_slam_frontend_tpu_torch.frontend.keyframe import keyframe_step

    left, right, t, q = inputs
    return keyframe_step(
        params, state, left, right, fid,
        capacity=config.max_features, window=config.frame_life, border=config.detect_border,
        blur_sigma=config.blur_sigma, mutual_check=config.mutual_check,
        curr_pose_t=t, curr_pose_q=q,
    )


def state_to(state, dev):
    import dataclasses

    from vision_slam_frontend_tpu_torch.frontend.keyframe import WindowState

    return WindowState(**{f.name: getattr(state, f.name).to(dev) for f in dataclasses.fields(state)})


def phase_parity(config, frames, dev):
    """keyframe_step on CUDA vs CPU from the same state, NUM_PARITY_KEYFRAMES times."""
    import dataclasses

    import torch

    from vision_slam_frontend_tpu_torch.frontend.keyframe import StepParams, WindowState

    cpu = torch.device("cpu")
    p_gpu = StepParams.from_config(config, dev)
    p_cpu = StepParams.from_config(config, cpu)
    s_cpu = WindowState.create(config.frame_life, config.max_features, config.stereo_threshold_init, cpu)
    in_gpu = step_inputs(frames, dev)
    in_cpu = step_inputs(frames, cpu)
    n_fields = 0
    float_err = 0.0
    for k in range(1, NUM_PARITY_KEYFRAMES + 1):
        s_gpu_new, r_gpu = run_step(p_gpu, state_to(s_cpu, dev), in_gpu[k], k - 1, config)
        s_cpu_new, r_cpu = run_step(p_cpu, s_cpu, in_cpu[k], k - 1, config)
        for obj_g, obj_c in ((r_gpu, r_cpu), (s_gpu_new, s_cpu_new)):
            for f in dataclasses.fields(obj_c):
                a, b = getattr(obj_g, f.name).cpu(), getattr(obj_c, f.name)
                if a.dtype.is_floating_point:
                    float_err = max(float_err, max_abs_err(a, b))
                else:
                    check_equal(f"keyframe {k}: {type(obj_c).__name__}.{f.name} CUDA vs CPU", a, b)
                    n_fields += 1
        s_cpu = s_cpu_new
    return n_fields, float_err


def compare_problems(gpu_npz: str, cpu_npz: str) -> str:
    a, b = np.load(gpu_npz), np.load(cpu_npz)
    check(sorted(a.files) == sorted(b.files), "npz keys differ between CUDA and CPU runs")
    for k in b.files:
        check(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, f"npz {k}: shape/dtype differ")
        if a[k].dtype.kind == "f":
            check(bool(np.isfinite(a[k]).all()), f"npz {k}: non-finite values")
    check(len(a["nodes_id"]) > 0 and len(a["feat_node"]) > 0, "empty problem")
    track_eq = float(np.mean(a["feat_track"] == b["feat_track"]))
    check(track_eq >= 0.99, f"only {track_eq:.4f} of track ids equal CUDA vs CPU")
    px = float(np.abs(a["feat_pixel"] - b["feat_pixel"]).max())
    check(px <= 1e-3, f"feature pixels differ by {px} px CUDA vs CPU")
    return (f"{len(a['nodes_id'])} nodes, {len(a['feat_node'])} features, "
            f"{len(a['vfm_factor'])} matches; track ids equal {track_eq:.4f}, max pixel diff {px:.2e}")


def phase_main(ck, dev, tmp):
    """The CLI on the card; returns the launch counts of that run."""
    import contextlib
    import io

    from vision_slam_frontend_tpu_torch.cli.slam_frontend import main as cli_main

    gpu_out = os.path.join(tmp, "gpu.npz")
    cpu_out = os.path.join(tmp, "cpu.npz")
    ck.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["--input", MAIN_INPUT, "--output", gpu_out, "--device", str(dev)])
    launches = dict(ck.LAUNCHES)
    check(rc == 0, f"CLI exit code {rc}")
    summary = [ln for ln in buf.getvalue().splitlines() if ln.startswith("Saved SLAM problem")]
    check(len(summary) == 1, "no summary line from the CLI")
    n_keyframes = len(np.load(gpu_out)["nodes_id"])
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")
    with contextlib.redirect_stdout(io.StringIO()):
        check(cli_main(["--input", MAIN_INPUT, "--output", cpu_out, "--device", "cpu"]) == 0, "CPU run failed")
    return summary[0], launches, n_keyframes, compare_problems(gpu_out, cpu_out)


def phase_sync_free(config, frames, dev):
    """One steady-state step, inputs already on the card, under sync-debug "error"."""
    import torch

    from vision_slam_frontend_tpu_torch.frontend.keyframe import StepParams, WindowState

    params = StepParams.from_config(config, dev)
    state = WindowState.create(config.frame_life, config.max_features, config.stereo_threshold_init, dev)
    inputs = step_inputs(frames[:4], dev)
    for k in range(1, 3):
        state, _ = run_step(params, state, inputs[k], k - 1, config)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, result = run_step(params, state, inputs[3], 2, config)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return int(result.num_features)


def phase_timing(ck, config, frames, dev):
    import torch

    from vision_slam_frontend_tpu_torch.frontend.keyframe import StepParams, WindowState
    from vision_slam_frontend_tpu_torch.ops.fast import fast_detect
    from vision_slam_frontend_tpu_torch.ops.image import gaussian_blur

    params = StepParams.from_config(config, dev)
    state = WindowState.create(config.frame_life, config.max_features, config.stereo_threshold_init, dev)
    inputs = step_inputs(frames, dev)
    step_ms = []
    for k in range(1, len(frames)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = run_step(params, state, inputs[k], k - 1, config)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    steady = step_ms[2:]  # the first keyframes pay one-time set-up

    img = inputs[1][0]
    kps, _, _ = fast_detect(img, threshold=12.0, max_keypoints=config.max_features, border=19)
    planes = gaussian_blur(img.float()).to(torch.float16)[None].contiguous()
    desc = state.desc  # (W, K, 8) window descriptors of the run above
    K = config.max_features
    q_window = desc.reshape(-1, desc.shape[-1]).contiguous()
    t_curr = desc[-1].contiguous()
    v_curr = state.valid[-1].contiguous()
    q_stereo = desc[-2].contiguous()
    cases = {
        "fast_scores_nms": (lambda: ck.fast_scores_nms(img), lambda: ck.fast_scores_nms_plain(img), "640x480"),
        "extract_patches": (lambda: ck.extract_patches(planes, kps, 31),
                            lambda: ck.extract_patches_plain(planes, kps, 31), f"K={K} C=1 ps=31 f16"),
        "hamming_top2": (lambda: ck.hamming_top2(q_window, t_curr, v_curr),
                         lambda: ck.hamming_top2_plain(q_window, t_curr, v_curr),
                         f"window {q_window.shape[0]}x{K} words=8"),
        "hamming_top2 (stereo)": (lambda: ck.hamming_top2(q_stereo, t_curr, v_curr),
                                  lambda: ck.hamming_top2_plain(q_stereo, t_curr, v_curr), f"stereo {K}x{K} words=8"),
    }
    # Plain, kernel, kernel, plain: the median of each pair.
    times = {}
    for name, (kernel, plain, shape) in cases.items():
        p1 = cuda_ms(plain)
        k1 = cuda_ms(kernel)
        k2 = cuda_ms(kernel)
        p2 = cuda_ms(plain)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2, shape)
    return statistics.median(steady), len(steady), times


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable ({e})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke test runs only on the GPU", file=sys.stderr)
        return 1
    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig
    from vision_slam_frontend_tpu_torch.frontend.config import FrontendConfig
    from vision_slam_frontend_tpu_torch.ops import _build
    from vision_slam_frontend_tpu_torch.ops import cuda_kernels as ck

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    say("1 device", f"{kind}, {count} visible; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)

    t0 = time.perf_counter()
    _build.library()
    built = (f"nvcc built {_build.library_path().name} in {_build.build_seconds:.1f} s"
             if _build.build_seconds is not None else f"{_build.library_path().name} already built")
    say("2 build", f"{built}; loaded in {time.perf_counter() - t0:.1f} s")

    config = FrontendConfig(calib=SyntheticRig().calib(), fast_threshold=12.0)
    frames = synthetic_frames(TIMING_KEYFRAMES + 1)

    errs = phase_kernels(ck, frames, dev)
    say("3 kernels", "kernel == plain version on the card, exact: "
        + ", ".join(f"{k} max_abs_err={v}" for k, v in errs.items()))

    n_fields, float_err = phase_parity(config, frames[: NUM_PARITY_KEYFRAMES + 1], dev)
    say("4 parity", f"{NUM_PARITY_KEYFRAMES} keyframes CUDA vs CPU: {n_fields} int/bool fields equal; "
        f"float fields max abs diff {float_err:.3g}")

    with tempfile.TemporaryDirectory() as tmp:
        summary, launches, n_kf, agreement = phase_main(ck, dev, tmp)
    n_feat = phase_sync_free(config, frames, dev)
    say("5 main", f"{summary}; launches {launches} over {n_kf} keyframes; vs CPU run: {agreement}; "
        f"steady step under sync-debug 'error' ok ({n_feat} features)")

    step_ms, n_steady, times = phase_timing(ck, config, frames, dev)
    say("6 timing", f"[{smi}] keyframe step median {step_ms:.3f} ms over {n_steady} steady keyframes "
        "(640x480, K=512, W=10); " + "; ".join(
            f"{name} {shape}: kernel {k:.4f} ms, plain {p:.4f} ms" for name, (k, p, shape) in times.items()))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        k_ms, p_ms, _ = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": k_ms, "plain_ms": p_ms,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
