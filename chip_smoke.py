#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure ends the run with a non-zero exit:
  1. device   a CUDA device is required (no CPU path); its name and
              `nvidia-smi` name/power limit and maximum SM clock
  2. build    nvcc builds the four kernels from csrc/ (sm_90a), one nvcc per
              source, all at once; each kernel's registers, shared memory
              and spills as `-Xptxas -v` reports them
  3. kernels  each kernel against its plain PyTorch version on the card, on
              the same inputs, at every shape the paths give it: FAST on
              uint8 and float32 frames and a pyramid level; patches for ORB,
              BRISK, FREAK, AKAZE and a pyramid level; Hamming at 8 and 16 words and at
              8192x8192; the window gather's five cases; then the edge cases
              of torch_edge_cases.py (Hamming ties at tile and block
              boundaries, ragged and tiny train sets; FAST at ragged sizes,
              constant images, plateaus, a checkerboard; patches at odd
              widths, planes at an element offset, K from 1 to 513, ps from
              1 to 33, keypoints at the edges and on .5; windows leaving the
              image, xs at every residue mod 4, ragged K). Exact equality
  4. parity   keyframe_step on CUDA vs on the CPU from the same state: the
              default ORB slice for 4 synthetic keyframes, then BRISK, FREAK,
              AKAZE and the 3-level ORB pyramid for 2 each (640x480, K=512,
              W=10): every int and bool field equal
  5. main     each path driven once with the launch counts set to 0 just
              before and read just after: the port's CLI on synthetic:20
              (ORB) and on synthetic:8 with --descriptor_family brisk, freak
              and akaze; the ORB pyramid through Frontend on 8 frames; the
              window-gather entry point (ops/kernel_variants) at the TPU
              probe's shapes. Each frontend run is checked against the CPU
              run of the same input; then one steady-state step per
              configuration under sync-debug mode "error"
  6. timing   median keyframe step time (synced, and host enqueue) per
              configuration with one profiled step's launches and device
              time (torch.profiler), and each kernel at each shape: its
              device time per launch (utils/cuda_timing.device_ms: 50
              launches in one CUDA graph, replayed behind a stream spin so
              the host cannot starve the window, median of 5), beside its
              plain version and one PyTorch call that computes the same
              function where there is one (timed the same way), its cost per
              call (CUDA events around one call), and its bound; at each
              kernel's main shape, torch.profiler's kernel durations as a
              cross-check ("not measured" where the profiler recorded no
              device trace: the CUDA-event times are the figures of
              record, and a missing trace fails nothing); the Hamming window shape's +-1 int8 product
              alone through torch._int_mm (product_ms, a yardstick); and the
              launch floor, a 1-element fill timed the same way
Then a JSON line of every kernel shape's numbers, the kernels JSON line and,
last, the result line.
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
NUM_FAMILY_PARITY_KEYFRAMES = 2
MAIN_INPUT = "synthetic:20"
FAMILY_INPUT = "synthetic:8"
FAMILY_FRAMES = 8
TIMING_KEYFRAMES = 20

# The H100's published peaks (NVIDIA data sheet, SXM, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
INT8_TENSOR_OPS_PER_S = 1979e12
# Issue rates per SM per clock (Hopper): min/max (FMNMX) at half the FP32
# add/multiply rate. Times the SM count and nvidia-smi's maximum SM clock.
SMS = 132
FMNMX_PER_CLOCK_SM = 64
FADD_PER_CLOCK_SM = 128
# FAST-9 + NMS per pixel: 16 ring - centre subtractions; 128 arc min/max by
# doubling (min and max of 2, 4, 8, 9 neighbours at 16 starts) and 32 for the
# two polarities and the best start, two values per instruction (half2) on a
# uint8 image, whose differences are exact in fp16; 8 NMS maxima and 1 compare.
FAST_SUBS_PER_PIXEL = 16
FAST_ARC_MINMAX_PER_PIXEL = 128 + 32
FAST_NMS_PER_PIXEL = 9

# Kernel name -> (CUDA source, the TPU kernel(s) it replaces, a substring of
# its CUDA kernel's symbol for torch.profiler).
KERNELS = {
    "fast_scores_nms": (
        "vision_slam_frontend_tpu_torch/csrc/fast_nms.cu",
        "vision_slam_frontend_tpu/ops/pallas_kernels.py:331",
        "fast_nms_kernel",
    ),
    "extract_patches": (
        "vision_slam_frontend_tpu_torch/csrc/extract_patches.cu",
        "vision_slam_frontend_tpu/ops/pallas_kernels.py:394",
        "extract_patches_kernel",
    ),
    "hamming_top2": (
        "vision_slam_frontend_tpu_torch/csrc/hamming_top2.cu",
        "vision_slam_frontend_tpu/ops/pallas_kernels.py:193 and vision_slam_frontend_tpu/ops/pallas_kernels.py:89",
        "hamming_top2_kernel",
    ),
    "patch_windows": (
        "vision_slam_frontend_tpu_torch/csrc/patch_windows.cu",
        "probe_kernel_variants.py:22",
        "patch_windows_kernel",
    ),
}
# The shape of each kernel that the kernels line reports (the others are on
# the line before it).
PRIMARY_SHAPE = {
    "fast_scores_nms": "640x480 u8",
    "extract_patches": "ORB K=512 C=1 ps=31 f16",
    "hamming_top2": "window 5120x512 words=8",
    "patch_windows": "E1 dyn-sublane, 32 rows, blk64",
}
# Frontend configurations: name -> FrontendConfig overrides.
CONFIGS = {
    "orb": {},
    "brisk": {"descriptor_family": "brisk"},
    "freak": {"descriptor_family": "freak"},
    "akaze": {"descriptor_family": "akaze"},
    "orb_pyramid": {"num_levels": 3},
}


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    """The first card's `nvidia-smi --query-gpu=<query>` line."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


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


def make_config(name: str):
    from vision_slam_frontend_tpu_torch.frontend.config import FrontendConfig
    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig

    return FrontendConfig(calib=SyntheticRig().calib(), fast_threshold=12.0, **CONFIGS[name])


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


def bound(bytes_moved: float, op_seconds: float = 0.0) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the larger of the
    bytes over the memory rate and the operations' time at their peak rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    return max(t_bytes, op_seconds) * 1e3, ("operations" if op_seconds > t_bytes else "bytes")


def fast_op_seconds(pixels: int, sm_hz: float, arc_values_per_op: int) -> float:
    """Least time of FAST-9 + NMS over `pixels` at the issue rates of its
    instructions (min/max at 64, subtraction at 128 per clock per SM), the
    arcs' min/max at `arc_values_per_op` values per instruction."""
    minmax = FAST_ARC_MINMAX_PER_PIXEL / arc_values_per_op + FAST_NMS_PER_PIXEL
    return pixels * (minmax / FMNMX_PER_CLOCK_SM + FAST_SUBS_PER_PIXEL / FADD_PER_CLOCK_SM) / (SMS * sm_hz)


def covered_pixels(ys, xs, rows: int, cols: int, H: int, W: int) -> int:
    """Distinct image pixels inside rows x cols windows at (ys, xs): what a
    gather of those windows must read at least once."""
    import torch

    dev = ys.device
    r = ys.long()[:, None, None] + torch.arange(rows, device=dev)[None, :, None]
    c = xs.long()[:, None, None] + torch.arange(cols, device=dev)[None, None, :]
    inside = (r >= 0) & (r < H) & (c >= 0) & (c < W)
    mask = torch.zeros(H * W, dtype=torch.bool, device=dev)
    mask[(r.clamp(0, H - 1) * W + c.clamp(0, W - 1))[inside]] = True
    return int(mask.sum())


# ---------------------------------------------------------------------------
# Kernel cases: every shape the paths give each kernel
# ---------------------------------------------------------------------------


def kernel_cases(ck, frames, dev, sm_hz):
    """[{kernel, shape, kernel fn, plain fn, library fn or None, bound_ms,
    bound_by}] at the main paths' shapes, on the card; `sm_hz` is the SM
    clock the FAST bound counts."""
    import torch

    from vision_slam_frontend_tpu_torch.ops import akaze, brief, brisk, freak
    from vision_slam_frontend_tpu_torch.ops.fast import fast_detect
    from vision_slam_frontend_tpu_torch.ops.image import gaussian_blur, resize_linear

    cases = []
    img = torch.from_numpy(u8(frames[1].left)).to(dev)
    H, W = img.shape

    # B1: uint8 frame, float32 frame (non-integer values), pyramid level.
    level = resize_linear(img.float(), (343, 457))
    for label, im in (("640x480 u8", img), ("640x480 f32", gaussian_blur(img.float(), sigma=1.0)),
                      ("457x343 f32 level", level)):
        h, w = im.shape
        b_ms, b_by = bound(h * w * (im.element_size() + 8),
                           fast_op_seconds(h * w, sm_hz, 2 if im.dtype == torch.uint8 else 1))
        cases.append(dict(kernel="fast_scores_nms", shape=label, kernel_fn=lambda im=im: ck.fast_scores_nms(im),
                          plain_fn=lambda im=im: ck.fast_scores_nms_plain(im), library_fn=None,
                          bound_ms=b_ms, bound_by=b_by))

    # B2: each family's planes at K=512, keypoints from the detector plus
    # clamped corners and exact .5 coordinates.
    kps, _, _ = fast_detect(img, threshold=12.0, max_keypoints=512, border=19)
    special = torch.tensor(
        [[0.0, 0.0], [639.0, 479.0], [-7.0, 3.0], [700.0, 500.0], [100.5, 200.5],
         [101.5, 33.5], [15.5, 15.5], [624.5, 464.5], [320.49, 240.51], [2.5, 477.5]],
        device=dev,
    )
    kps = torch.cat([kps[: 512 - len(special)], special]).contiguous()
    imf = img.float()
    L = akaze.build_scale_space(imf, 1, 1.4)[0]
    Lx, Ly = akaze.grad_central(L)
    # The pyramid's second level: its share of the budget (brief.level_budgets)
    # at the level's coordinates.
    level_kps = (kps[: brief.level_budgets(512, 3)[1]] / 1.4).contiguous()
    for label, planes, ps, k_in in (
        ("ORB K=512 C=1 ps=31 f16", gaussian_blur(imf).to(torch.float16)[None], 31, kps),
        ("BRISK K=512 C=5 ps=27 f32", torch.stack([gaussian_blur(imf, sigma=s) for s in brisk.SIGMAS]), 27, kps),
        ("FREAK K=512 C=7 ps=27 f32", torch.stack([gaussian_blur(imf, sigma=s) for s in freak.SIGMAS]), 27, kps),
        ("AKAZE K=512 C=3 ps=31 f32", torch.stack([L, Lx, Ly]), 31, kps),
        (f"ORB pyramid level 457x343 K={len(level_kps)} C=1 ps=31 f16",
         gaussian_blur(level).to(torch.float16)[None], 31, level_kps),
    ):
        planes = planes.contiguous()
        C, H, W = planes.shape
        r = ps // 2
        xs = (torch.round(k_in[:, 0]).long() - r).clamp(0, W - ps)
        ys = (torch.round(k_in[:, 1]).long() - r).clamp(0, H - ps)
        off = torch.arange(ps, device=dev)
        r_idx = (ys[:, None, None] + off[None, :, None]).expand(-1, ps, ps)
        c_idx = (xs[:, None, None] + off[None, None, :]).expand(-1, ps, ps)
        elem = planes.element_size()
        b_ms, b_by = bound(covered_pixels(ys, xs, ps, ps, H, W) * C * elem + k_in.numel() * 4
                           + k_in.shape[0] * C * ps * ps * elem)
        cases.append(dict(kernel="extract_patches", shape=label,
                          kernel_fn=lambda p=planes, ps=ps, k=k_in: ck.extract_patches(p, k, ps),
                          plain_fn=lambda p=planes, ps=ps, k=k_in: ck.extract_patches_plain(p, k, ps),
                          library_fn=lambda p=planes, ri=r_idx, ci=c_idx: p[:, ri, ci].transpose(0, 1),
                          bound_ms=b_ms, bound_by=b_by))

    # B3/B4: stereo 512x512 and window 5120x512 at 8 and 16 words, and the
    # reference's K=8192 setting.
    rng = np.random.default_rng(0)
    for kq, kt, words in ((5120, 512, 8), (512, 512, 8), (5120, 512, 16), (512, 512, 16), (8192, 8192, 8)):
        q = torch.from_numpy(rng.integers(0, 2**32, (kq, words), dtype=np.uint32).view(np.int32)).to(dev)
        t = torch.from_numpy(rng.integers(0, 2**32, (kt, words), dtype=np.uint32).view(np.int32)).to(dev)
        v = torch.from_numpy(rng.random(kt) >= 0.3).to(dev)
        n_valid = int(v.sum())
        # The b1 products' rate is unpublished: they are counted at the int8
        # tensor rate, and the bytes' time is reported beside it.
        n_bytes = (kq + kt) * words * 4 + kt + kq * 12
        b_ms, b_by = bound(n_bytes, 2.0 * kq * n_valid * words * 32 / INT8_TENSOR_OPS_PER_S)
        kind = "K=8192" if kq == 8192 else ("window" if kq > kt else "stereo")
        cases.append(dict(kernel="hamming_top2", shape=f"{kind} {kq}x{kt} words={words}",
                          kernel_fn=lambda q=q, t=t, v=v: ck.hamming_top2(q, t, v),
                          plain_fn=lambda q=q, t=t, v=v: ck.hamming_top2_plain(q, t, v), library_fn=None,
                          bound_ms=b_ms, bound_by=b_by, bound_bytes_ms=bound(n_bytes)[0]))
    return cases


def window_cases(ck, dev):
    """B5's five cases at the TPU probe's shapes (480x640, K=8192)."""
    import torch

    from vision_slam_frontend_tpu_torch.ops import kernel_variants as kv

    H, W, K = kv.PROBE_SHAPE
    img, ys, xs = kv.probe_inputs(H, W, K, dev)
    cases = []
    for name, rows, shifted, block in kv.CASES:
        cover = covered_pixels(ys, xs if shifted else torch.zeros_like(xs), rows, ck.WINDOW_COLS, H, W)
        b_ms, b_by = bound(cover * 4 + K * 8 + K * rows * ck.WINDOW_COLS * 4)
        cases.append(dict(kernel="patch_windows", shape=name, bound_ms=b_ms, bound_by=b_by,
                          kernel_fn=lambda r=rows, s=shifted, b=block: ck.patch_windows(img, ys, xs, r, s, b),
                          plain_fn=lambda r=rows, s=shifted, b=block: ck.patch_windows_plain(img, ys, xs, r, s, b)))
    return (img, ys, xs), cases


def compare_outputs(what: str, out, ref) -> float:
    """Exact equality of a kernel's output(s) with the plain version's;
    returns the max abs error (0)."""
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = 0.0
    for i, (a, b) in enumerate(zip(outs, refs)):
        check_equal(f"{what} output {i} vs plain", a, b)
        err = max(err, max_abs_err(a, b))
    return err


def phase_kernels(ck, cases, windows, dev):
    """Each case, plus edge cases, against the plain version; returns (the
    max error per kernel, the number of edge cases)."""
    import torch
    import torch_edge_cases as edge_cases

    errs = {name: 0.0 for name in KERNELS}
    for c in cases + windows:
        out = c["kernel_fn"]()
        torch.cuda.synchronize()
        ref = c["plain_fn"]()
        errs[c["kernel"]] = max(errs[c["kernel"]], compare_outputs(f"{c['kernel']} {c['shape']}", out, ref))
        if c.get("library_fn") is not None:  # the timed library call computes the same function
            check_equal(f"{c['kernel']} {c['shape']} library call vs plain", c["library_fn"](),
                        ref.reshape(c["library_fn"]().shape))
    # Hamming edge cases: all trains invalid (1e9 sentinels), ragged sizes,
    # large 16-word sets.
    rng = np.random.default_rng(1)
    for kq, kt, words, invalid in ((512, 512, 8, 1.0), (77, 300, 8, 0.5), (2048, 2048, 16, 0.2), (64, 1, 16, 0.0)):
        q = torch.from_numpy(rng.integers(0, 2**32, (kq, words), dtype=np.uint32).view(np.int32)).to(dev)
        t = torch.from_numpy(rng.integers(0, 2**32, (kt, words), dtype=np.uint32).view(np.int32)).to(dev)
        v = torch.from_numpy(rng.random(kt) >= invalid).to(dev)
        out = ck.hamming_top2(q, t, v)
        torch.cuda.synchronize()
        what = f"hamming_top2 {kq}x{kt} words={words} invalid={invalid}"
        errs["hamming_top2"] = max(errs["hamming_top2"], compare_outputs(what, out, ck.hamming_top2_plain(q, t, v)))
    n_edge = 0
    for label, (q, t, v) in edge_cases.hamming_cases():
        q, t = (torch.from_numpy(a.view(np.int32)).to(dev) for a in (q, t))
        v = torch.from_numpy(v).to(dev)
        out = ck.hamming_top2(q, t, v)
        torch.cuda.synchronize()
        errs["hamming_top2"] = max(errs["hamming_top2"], compare_outputs(
            f"hamming_top2 edge case {label}", out, ck.hamming_top2_plain(q, t, v)))
        n_edge += 1
    for label, img in edge_cases.fast_cases():
        img = torch.from_numpy(img).to(dev)
        out = ck.fast_scores_nms(img)
        torch.cuda.synchronize()
        errs["fast_scores_nms"] = max(errs["fast_scores_nms"], compare_outputs(
            f"fast_scores_nms edge case {label}", out, ck.fast_scores_nms_plain(img)))
        n_edge += 1
    for label, planes, kps, ps, offset in edge_cases.patch_cases():
        planes = edge_cases.at_offset(planes, offset, dev)
        kps = torch.from_numpy(kps).to(dev)
        out = ck.extract_patches(planes, kps, ps)
        torch.cuda.synchronize()
        errs["extract_patches"] = max(errs["extract_patches"], compare_outputs(
            f"extract_patches edge case {label}", out, ck.extract_patches_plain(planes, kps, ps)))
        n_edge += 1
    for label, img, ys, xs, rows, shifted, block, offset in edge_cases.window_cases():
        img = edge_cases.at_offset(img, offset, dev)
        ys, xs = torch.from_numpy(ys).to(dev), torch.from_numpy(xs).to(dev)
        out = ck.patch_windows(img, ys, xs, rows, shifted, block)
        torch.cuda.synchronize()
        errs["patch_windows"] = max(errs["patch_windows"], compare_outputs(
            f"patch_windows edge case {label}", out, ck.patch_windows_plain(img, ys, xs, rows, shifted, block)))
        n_edge += 1
    return errs, n_edge


# ---------------------------------------------------------------------------
# Steps, parity, main paths
# ---------------------------------------------------------------------------


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
        blur_sigma=config.blur_sigma, num_levels=config.num_levels, scale_factor=config.pyramid_scale,
        descriptor_family=config.descriptor_family, mutual_check=config.mutual_check,
        curr_pose_t=t, curr_pose_q=q,
    )


def new_state(config, dev):
    from vision_slam_frontend_tpu_torch.frontend.keyframe import WindowState
    from vision_slam_frontend_tpu_torch.ops.descriptors import get_family

    return WindowState.create(config.frame_life, config.max_features, config.stereo_threshold_init, dev,
                              words=get_family(config.descriptor_family).words)


def state_to(state, dev):
    import dataclasses

    from vision_slam_frontend_tpu_torch.frontend.keyframe import WindowState

    return WindowState(**{f.name: getattr(state, f.name).to(dev) for f in dataclasses.fields(state)})


def phase_parity(config, in_gpu, in_cpu, n_keyframes, dev):
    """keyframe_step on CUDA vs CPU from the same state, n_keyframes times."""
    import dataclasses

    import torch

    from vision_slam_frontend_tpu_torch.frontend.keyframe import StepParams

    cpu = torch.device("cpu")
    p_gpu = StepParams.from_config(config, dev)
    p_cpu = StepParams.from_config(config, cpu)
    s_cpu = new_state(config, cpu)
    n_fields = 0
    float_err = 0.0
    for k in range(1, n_keyframes + 1):
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
        check(int(r_cpu.num_features) > 50, f"keyframe {k}: only {int(r_cpu.num_features)} features")
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


def check_launches(path: str, launches: dict, runs: tuple[str, ...], absent: tuple[str, ...] = ()) -> None:
    for name in runs:
        check(launches[name] > 0, f"{path}: kernel {name} was not launched")
    for name in absent:
        check(launches[name] == 0, f"{path}: kernel {name} was launched {launches[name]} times")


def run_cli(ck, argv, dev, tmp, tag):
    """The CLI on the card (launch counts from that run), then on the CPU;
    returns (summary line, launches, keyframes, agreement)."""
    import contextlib
    import io

    from vision_slam_frontend_tpu_torch.cli.slam_frontend import main as cli_main

    gpu_out = os.path.join(tmp, f"{tag}_gpu.npz")
    cpu_out = os.path.join(tmp, f"{tag}_cpu.npz")
    buf = io.StringIO()
    ck.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([*argv, "--output", gpu_out, "--device", str(dev)])
    launches = dict(ck.LAUNCHES)
    check(rc == 0, f"CLI {argv} exit code {rc}")
    summary = [ln for ln in buf.getvalue().splitlines() if ln.startswith("Saved SLAM problem")]
    check(len(summary) == 1, f"no summary line from the CLI {argv}")
    with contextlib.redirect_stdout(io.StringIO()):
        check(cli_main([*argv, "--output", cpu_out, "--device", "cpu"]) == 0, f"CPU run {argv} failed")
    return summary[0], launches, len(np.load(gpu_out)["nodes_id"]), compare_problems(gpu_out, cpu_out)


def run_frontend(ck, config, frames, dev, tmp, tag):
    """Frontend over `frames` on the card (launch counts from that run),
    then on the CPU; returns (summary, launches, keyframes, agreement)."""
    import torch

    from vision_slam_frontend_tpu_torch.frontend import Frontend
    from vision_slam_frontend_tpu_torch.io.serialize import save_problem

    paths, summaries, launches = [], [], None
    for i, device in enumerate((dev, torch.device("cpu"))):
        ck.reset_launch_counts()
        fe = Frontend(config, device=device)
        for f in frames:
            fe.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
            fe.observe_image(f.left, f.right, f.timestamp)
        problem = fe.get_slam_problem()
        if i == 0:
            launches = dict(ck.LAUNCHES)
        paths.append(os.path.join(tmp, f"{tag}_{i}.npz"))
        save_problem(paths[-1], problem, config=config, node_track_ids=fe.node_track_ids)
        summaries.append(problem.summary())
    return summaries[0], launches, len(np.load(paths[0])["nodes_id"]), compare_problems(*paths)


def phase_main(ck, frames, window_inputs, dev, tmp):
    """Every path once; returns ({path: launches}, lines, B5 results)."""
    from vision_slam_frontend_tpu_torch.ops import kernel_variants as kv

    frontend_kernels = ("fast_scores_nms", "extract_patches", "hamming_top2")
    per_path = {}
    lines = []
    summary, launches, n_kf, agreement = run_cli(ck, ["--input", MAIN_INPUT], dev, tmp, "orb")
    check_launches("ORB CLI", launches, frontend_kernels, absent=("patch_windows",))
    per_path["orb"] = launches
    lines.append(f"ORB {MAIN_INPUT}: {summary}; launches {launches} over {n_kf} keyframes; vs CPU: {agreement}")
    for fam in ("brisk", "freak", "akaze"):
        summary, launches, n_kf, agreement = run_cli(
            ck, ["--input", FAMILY_INPUT, "--descriptor_family", fam], dev, tmp, fam)
        if fam == "akaze":  # AKAZE detects on the Hessian response: no FAST kernel
            check_launches("AKAZE CLI", launches, ("extract_patches", "hamming_top2"),
                           absent=("fast_scores_nms", "patch_windows"))
        else:
            check_launches(f"{fam} CLI", launches, frontend_kernels, absent=("patch_windows",))
        per_path[fam] = launches
        lines.append(f"{fam} {FAMILY_INPUT}: {summary}; launches {launches} over {n_kf} keyframes; vs CPU: {agreement}")
    summary, launches, n_kf, agreement = run_frontend(ck, make_config("orb_pyramid"), frames[:FAMILY_FRAMES], dev,
                                                      tmp, "pyramid")
    check_launches("ORB pyramid", launches, frontend_kernels, absent=("patch_windows",))
    per_path["orb_pyramid"] = launches
    lines.append(f"ORB 3-level pyramid, {FAMILY_FRAMES} frames: {summary}; launches {launches} over {n_kf} "
                 f"keyframes; vs CPU: {agreement}")
    # The window-gather entry point (ops/kernel_variants), at the probe's shapes.
    ck.reset_launch_counts()
    b5 = kv.run_cases(*window_inputs)
    launches = dict(ck.LAUNCHES)
    check_launches("kernel_variants", launches, ("patch_windows",),
                   absent=("fast_scores_nms", "extract_patches", "hamming_top2"))
    per_path["kernel_variants"] = launches
    lines.append(f"kernel_variants at H=480 W=640 K=8192: 5 cases exact; launches {launches}")
    return per_path, lines, b5


def phase_sync_free(frames, dev):
    """One steady-state step per configuration, inputs already on the card,
    under sync-debug "error"."""
    import torch

    from vision_slam_frontend_tpu_torch.frontend.keyframe import StepParams

    inputs = step_inputs(frames[:4], dev)
    out = {}
    for name in CONFIGS:
        config = make_config(name)
        params = StepParams.from_config(config, dev)
        state = new_state(config, dev)
        for k in range(1, 3):
            state, _ = run_step(params, state, inputs[k], k - 1, config)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            state, result = run_step(params, state, inputs[3], 2, config)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        out[name] = int(result.num_features)
    return out


def step_times(config, inputs, dev):
    """Median synced keyframe step time and median host enqueue time (ms,
    host clock) over the steady keyframes, and their count."""
    import torch

    from vision_slam_frontend_tpu_torch.frontend.keyframe import StepParams

    params = StepParams.from_config(config, dev)
    state = new_state(config, dev)
    step_ms, enqueue_ms = [], []
    for k in range(1, len(inputs)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = run_step(params, state, inputs[k], k - 1, config)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        enqueue_ms.append((t1 - t0) * 1e3)
    # The first keyframes pay one-time set-up.
    return statistics.median(step_ms[2:]), statistics.median(enqueue_ms[2:]), len(step_ms) - 2


def profile_step(config, inputs, dev):
    """Kernel launches and device time (ms) of one steady step, from
    torch.profiler: (launches, device ms), each None where the profiler
    recorded no such event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from vision_slam_frontend_tpu_torch.frontend.keyframe import StepParams

    params = StepParams.from_config(config, dev)
    state = new_state(config, dev)
    for k in range(1, 4):
        state, _ = run_step(params, state, inputs[k], k - 1, config)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_step(params, state, inputs[4], 3, config)
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel"))
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in device) / 1e3 if device else None
    return launches or None, device_ms


def product_ms(ck, dev) -> float:
    """Device time of the Hamming window shape's distance product alone: the
    +-1 int8 (5120, 256) @ (256, 512) through torch._int_mm (cuBLAS), checked
    against the plain distances. A yardstick: the port never calls it."""
    import torch

    from vision_slam_frontend_tpu_torch.ops.brief import unpack_bits
    from vision_slam_frontend_tpu_torch.utils.cuda_timing import device_ms

    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.integers(0, 2**32, (5120, 8), dtype=np.uint32).view(np.int32)).to(dev)
    t = torch.from_numpy(rng.integers(0, 2**32, (512, 8), dtype=np.uint32).view(np.int32)).to(dev)
    bq, bt = unpack_bits(q), unpack_bits(t)
    sq = (1 - 2 * bq).to(torch.int8)
    st = (1 - 2 * bt).to(torch.int8).t().contiguous()
    dot = torch._int_mm(sq, st)
    dist = bq.sum(1)[:, None] + bt.sum(1)[None, :] - 2.0 * (bq @ bt.T)
    check(torch.equal((256 - dot).float() / 2, dist), "the +-1 int8 product disagrees with the plain distances")
    return device_ms(lambda: torch._int_mm(sq, st))


def phase_timing(ck, cases, frames, dev):
    """Step medians per configuration; each kernel case's times; the
    profiler's kernel durations at each kernel's main shape; product_ms; and
    the launch floor: the device time of the smallest kernel (a 1-element
    fill) timed the same way."""
    import torch

    from vision_slam_frontend_tpu_torch.utils.cuda_timing import call_ms, device_ms, profiled_kernel_ms

    inputs = step_inputs(frames, dev)
    steps = {name: step_times(make_config(name), inputs, dev) + profile_step(make_config(name), inputs, dev)
             for name in CONFIGS}
    rows = []
    for c in cases:
        # Plain, kernel, kernel, plain: the mean of each pair's device times.
        p1, k1, k2, p2 = (device_ms(c["plain_fn"]), device_ms(c["kernel_fn"]), device_ms(c["kernel_fn"]),
                          device_ms(c["plain_fn"]))
        lib = device_ms(c["library_fn"]) if c["library_fn"] is not None else None
        row = dict(kernel=c["kernel"], shape=c["shape"], ms=(k1 + k2) / 2, call_ms=call_ms(c["kernel_fn"]),
                   plain_ms=(p1 + p2) / 2, library_ms=lib, bound_ms=c["bound_ms"], bound_by=c["bound_by"])
        if "bound_bytes_ms" in c:
            row["bound_bytes_ms"] = c["bound_bytes_ms"]
        if PRIMARY_SHAPE[c["kernel"]] == c["shape"]:
            row["profiled_ms"], row["kernels_per_call"], row["profiled_device_events"] = profiled_kernel_ms(
                c["kernel_fn"], KERNELS[c["kernel"]][2])
        rows.append(row)
    one = torch.empty(1, device=dev)
    return steps, rows, product_ms(ck, dev), device_ms(lambda: one.fill_(0.0))


def profiler_note(row) -> str:
    """The profiler's cross-check of a timing row, for phase 6's line."""
    if "profiled_ms" not in row:
        return ""
    if row["profiled_ms"] is None:
        return f" (profiler not measured: {row['profiled_device_events']} device events recorded, none of this kernel)"
    return f" (profiler {row['profiled_ms']:.5f})"


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable ({e})", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this smoke test runs only on the GPU", file=sys.stderr)
        return 1
    from vision_slam_frontend_tpu_torch.ops import _build
    from vision_slam_frontend_tpu_torch.ops import cuda_kernels as ck
    from vision_slam_frontend_tpu_torch.utils.cuda_timing import profiled_kernel_ms

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi("name,power.limit")
    sm_mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    say("1 device", f"{kind}, {count} visible; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"max SM clock {sm_mhz:.0f} MHz")
    print(smi, flush=True)

    t0 = time.perf_counter()
    _build.library()
    built = (f"nvcc built {_build.library_path().name} in {_build.build_seconds:.1f} s"
             if _build.build_seconds is not None else f"{_build.library_path().name} already built")
    resources = _build.kernel_resources()
    say("2 build", f"{built}; loaded in {time.perf_counter() - t0:.1f} s; ptxas: " + " | ".join(
        f"{fn}: {info}" for fn, info in resources.items() if any(k[2] in fn for k in KERNELS.values())))

    frames = synthetic_frames(TIMING_KEYFRAMES + 1)

    cases = kernel_cases(ck, frames, dev, sm_mhz * 1e6)
    window_inputs, windows = window_cases(ck, dev)
    errs, n_edge = phase_kernels(ck, cases, windows, dev)
    say("3 kernels", f"kernel == plain version on the card, exact, at {len(cases) + len(windows)} shapes and "
        f"{n_edge} edge cases: " + ", ".join(f"{k} max_abs_err={v}" for k, v in errs.items()))

    cpu = torch.device("cpu")
    in_gpu = step_inputs(frames[: NUM_PARITY_KEYFRAMES + 1], dev)
    in_cpu = step_inputs(frames[: NUM_PARITY_KEYFRAMES + 1], cpu)
    parity = []
    for name in CONFIGS:
        n_kf = NUM_PARITY_KEYFRAMES if name == "orb" else NUM_FAMILY_PARITY_KEYFRAMES
        n_fields, float_err = phase_parity(make_config(name), in_gpu, in_cpu, n_kf, dev)
        parity.append(f"{name} {n_kf} keyframes: {n_fields} int/bool fields equal, float max abs diff {float_err:.3g}")
    say("4 parity", "CUDA vs CPU at 640x480, K=512, W=10: " + "; ".join(parity))

    with tempfile.TemporaryDirectory() as tmp:
        per_path, lines, b5 = phase_main(ck, frames, window_inputs, dev, tmp)
    n_feat = phase_sync_free(frames, dev)
    say("5 main", " | ".join(lines) + f" | steady step under sync-debug 'error' ok, features {n_feat}")

    steps, rows, prod_ms, floor_ms = phase_timing(ck, cases, frames, dev)
    bounds = {w["shape"]: w for w in windows}
    img, ys, xs = window_inputs
    for r in b5:  # timed by the entry point in phase 5
        w = bounds[r["name"]]
        row = dict(kernel="patch_windows", shape=r["name"], ms=r["ms"], call_ms=r["call_ms"], plain_ms=r["plain_ms"],
                   library_ms=r["library_ms"], bound_ms=w["bound_ms"], bound_by=w["bound_by"])
        if r["name"] == PRIMARY_SHAPE["patch_windows"]:
            row["profiled_ms"], row["kernels_per_call"], row["profiled_device_events"] = profiled_kernel_ms(
                lambda: ck.patch_windows(img, ys, xs, 32, False, 64), KERNELS["patch_windows"][2])
        rows.append(row)
    say("6 timing", f"[{smi}] keyframe step (640x480, K=512, W=10), medians over steady keyframes: " + "; ".join(
        f"{name} {ms:.3f} ms synced, {enq:.3f} ms enqueue ({n} keyframes), profiled step "
        + ("launches not measured" if nl is None else f"{nl} launches") + ", "
        + ("device time not measured" if dev_ms is None else f"{dev_ms:.3f} ms device")
        for name, (ms, enq, n, nl, dev_ms) in steps.items()))
    say("6 timing", f"[{smi}] device ms per launch (CUDA graph of 50, median of 5) | " + "; ".join(
        f"{r['kernel']} {r['shape']}: kernel {r['ms']:.5f} ms"
        + profiler_note(r)
        + f", call {r['call_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
        + ("none" if r["library_ms"] is None else f"{r['library_ms']:.5f} ms")
        + f", bound {r['bound_ms']:.5f} ms ({r['bound_by']}"
        + (f" at the int8 tensor rate, the b1 rate being unpublished; bytes alone {r['bound_bytes_ms']:.5f} ms)"
           if "bound_bytes_ms" in r else ")") for r in rows))
    say("6 timing", f"[{smi}] hamming_top2 yardstick: +-1 int8 product of the window shape (5120x256 @ 256x512) "
        f"through torch._int_mm, product_ms {prod_ms:.5f} ms; launch floor (a 1-element fill, same method) "
        f"{floor_ms:.5f} ms")
    say("6 timing", f"whole run {time.perf_counter() - t_start:.1f} s")

    launches = {name: sum(p[name] for p in per_path.values()) for name in KERNELS}
    print(json.dumps({"card": smi, "max_sm_mhz": sm_mhz, "ptxas": resources,
                      "steps": {k: dict(zip(("ms", "enqueue_ms", "keyframes", "launches", "device_ms"), v))
                                for k, v in steps.items()}, "shapes": rows, "product_ms": prod_ms,
                      "launch_floor_ms": floor_ms,
                      "launches_per_path": per_path}), flush=True)
    kernels = []
    for name, (source, replaces, _) in KERNELS.items():
        r = next(x for x in rows if x["kernel"] == name and x["shape"] == PRIMARY_SHAPE[name])
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
