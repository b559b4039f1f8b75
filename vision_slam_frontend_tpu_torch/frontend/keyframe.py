"""The per-keyframe device step (port of frontend/keyframe.py).

detect + describe (L, R) -> stereo ratio match -> adaptive epipolar gate ->
compact survivors -> window match (all W past frames in one kernel launch)
-> odometry-guided gate -> track propagation -> undistort + triangulate ->
window update.

The step is eager PyTorch over fixed-capacity masked tensors on one device.
It never waits for the device: no `.item()`, no `nonzero()`, no boolean
indexing, no Python branch on a tensor, and no copy from host memory (the
constant tables are uploaded once per device, ops/brief._tables). The
caller's WindowState is never mutated; the step returns a new one.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from vision_slam_frontend_tpu_torch.geometry.camera import (
    Intrinsics,
    epipolar_residual,
    triangulate_points,
    undistort_points,
)
from vision_slam_frontend_tpu_torch.geometry.rotation import quat_to_matrix
from vision_slam_frontend_tpu_torch.ops.descriptors import get_family
from vision_slam_frontend_tpu_torch.ops.hamming import match_window, ratio_test_match


def _scalar(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


@dataclasses.dataclass
class StepParams:
    """Calibration + thresholds of the keyframe step, on one device."""

    fundamental: torch.Tensor  # (3, 3)
    P_left: torch.Tensor  # (3, 4)
    P_right: torch.Tensor  # (3, 4)
    intr_left: Intrinsics
    intr_right: Intrinsics
    nn_match_ratio: torch.Tensor  # 0-d f32
    best_percent: torch.Tensor
    stereo_padding: torch.Tensor
    fast_threshold: torch.Tensor
    cam_R: torch.Tensor  # (3, 3) left-camera -> robot rotation
    cam_t: torch.Tensor  # (3,) left-camera -> robot translation
    guided_radius: torch.Tensor  # px; <= 0 disables the guided gate

    @classmethod
    def from_config(cls, config, device) -> "StepParams":
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        ext = np.asarray(config.left_cam_to_robot, np.float32)
        return cls(
            fundamental=f32(config.fundamental),
            P_left=f32(config.P_left),
            P_right=f32(config.P_right),
            intr_left=config.intrinsics_left,
            intr_right=config.intrinsics_right,
            nn_match_ratio=_scalar(config.nn_match_ratio, device),
            best_percent=_scalar(config.best_percent, device),
            stereo_padding=_scalar(config.stereo_threshold_padding, device),
            fast_threshold=_scalar(config.fast_threshold, device),
            cam_R=f32(ext[:3, :3]),
            cam_t=f32(ext[:3, 3]),
            guided_radius=_scalar(config.guided_match_radius, device),
        )


@dataclasses.dataclass
class WindowState:
    """Sliding window of the last W keyframes; slot 0 is the oldest.
    Descriptors are int32 words holding the reference's uint32 bits
    (hamming families) or float32 vectors (l2 families)."""

    kps: torch.Tensor  # (W, K, 2) f32 raw pixel coords
    desc: torch.Tensor  # (W, K, words) int32 packed words or float32 vectors
    valid: torch.Tensor  # (W, K) bool
    track_id: torch.Tensor  # (W, K) int32
    frame_id: torch.Tensor  # (W,) int32, -1 for empty slots
    count: torch.Tensor  # 0-d int32: filled slots
    stereo_threshold: torch.Tensor  # 0-d f32 adaptive epipolar gate
    points3d: torch.Tensor  # (W, K, 3) stereo-triangulated left-camera points
    pose_t: torch.Tensor  # (W, 3) odometry world pose at each keyframe
    pose_q: torch.Tensor  # (W, 4) [w, x, y, z]

    @classmethod
    def create(cls, window: int, capacity: int, stereo_threshold_init: float, device,
               words: int = 8, desc_dtype: torch.dtype = torch.int32) -> "WindowState":
        pose_q = torch.zeros((window, 4), dtype=torch.float32, device=device)
        pose_q[:, 0] = 1.0
        return cls(
            kps=torch.zeros((window, capacity, 2), dtype=torch.float32, device=device),
            desc=torch.zeros((window, capacity, words), dtype=desc_dtype, device=device),
            valid=torch.zeros((window, capacity), dtype=torch.bool, device=device),
            track_id=torch.zeros((window, capacity), dtype=torch.int32, device=device),
            frame_id=torch.full((window,), -1, dtype=torch.int32, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
            stereo_threshold=_scalar(stereo_threshold_init, device),
            points3d=torch.zeros((window, capacity, 3), dtype=torch.float32, device=device),
            pose_t=torch.zeros((window, 3), dtype=torch.float32, device=device),
            pose_q=pose_q,
        )

    @classmethod
    def from_numpy(cls, mapping: Mapping[str, np.ndarray], device) -> "WindowState":
        """From numpy arrays keyed by field name (the JAX package's
        WindowState leaves) or by the JAX package's checkpoint keys
        (`ckpt_window_<field>`, `ckpt_stereo_threshold`). Descriptors keep
        float32 (l2 families); uint32 words keep their bits as int32."""

        def get(name):
            for key in (name, f"ckpt_window_{name}", f"ckpt_{name}"):
                if key in mapping:
                    return np.asarray(mapping[key])
            raise KeyError(f"WindowState.from_numpy: no array for {name!r}")

        dtypes = {"desc": np.int32, "valid": np.bool_, "track_id": np.int32,
                  "frame_id": np.int32, "count": np.int32}
        fields = {}
        for f in dataclasses.fields(cls):
            a = get(f.name)
            if f.name == "desc" and a.dtype.kind == "f":
                a = a.astype(np.float32)
            elif a.dtype == np.uint32:
                a = a.view(np.int32)
            else:
                a = a.astype(dtypes.get(f.name, np.float32))
            fields[f.name] = torch.from_numpy(np.array(a, order="C")).to(device)
        return cls(**fields)


@dataclasses.dataclass
class KeyframeResult:
    """Per-keyframe outputs handed back to the host accumulator."""

    pixels_undist: torch.Tensor  # (K, 2) undistorted left pixels
    pixels_raw: torch.Tensor  # (K, 2)
    right_pixels_raw: torch.Tensor  # (K, 2) matched right pixel per stereo pair
    right_pixels_undist: torch.Tensor  # (K, 2)
    points3d: torch.Tensor  # (K, 3) left-camera-frame 3D points
    feat_valid: torch.Tensor  # (K,) bool; survivors compacted to the front
    track_id: torch.Tensor  # (K,) int32 persistent landmark track ids
    window_curr_idx: torch.Tensor  # (W, K) int32 current feature matched by past feature q
    window_match_dist: torch.Tensor  # (W, K) f32
    window_matched: torch.Tensor  # (W, K) bool
    window_frame_id: torch.Tensor  # (W,) int32 pose id of each slot (pre-update)
    num_features: torch.Tensor  # 0-d int32
    num_stereo_candidates: torch.Tensor  # 0-d int32
    stereo_threshold: torch.Tensor  # 0-d f32 (post-update)


def keyframe_step(
    params: StepParams,
    state: WindowState,
    left_image: torch.Tensor,
    right_image: torch.Tensor,
    frame_id: int,
    capacity: int = 512,
    window: int = 10,
    border: int = 19,
    blur_sigma: float = 2.0,
    num_levels: int = 1,
    scale_factor: float = 1.4,
    descriptor_family: str = "orb",
    mutual_check: bool = True,
    curr_pose_t: torch.Tensor | None = None,
    curr_pose_q: torch.Tensor | None = None,
) -> tuple[WindowState, KeyframeResult]:
    """Process one stereo keyframe of (H, W) uint8 images on the state's
    device. Returns (new_state, KeyframeResult).

    `curr_pose_t`/`curr_pose_q` is the current odometry world pose; when
    given, the odometry-guided match gate runs and the window carries the
    pose. None disables the gate."""
    K = capacity
    W = window
    dev = state.count.device

    # --- 1. Feature extraction, both cameras.
    extract = get_family(descriptor_family).extractor
    l_kps, _, l_desc, l_valid = extract(
        left_image, threshold=params.fast_threshold, max_keypoints=K,
        border=border, blur_sigma=blur_sigma, num_levels=num_levels, scale_factor=scale_factor,
    )
    r_kps, _, r_desc, r_valid = extract(
        right_image, threshold=params.fast_threshold, max_keypoints=K,
        border=border, blur_sigma=blur_sigma, num_levels=num_levels, scale_factor=scale_factor,
    )

    # --- 2. Stereo ratio-test match, left queries vs right trains.
    r_idx, _, s_matched = ratio_test_match(l_desc, l_valid, r_desc, r_valid, params.nn_match_ratio)

    # --- 3. Adaptive epipolar gate.
    matched_r_kps = r_kps[r_idx.long()]
    res = epipolar_residual(params.fundamental, l_kps, matched_r_kps)
    keep = s_matched & (res <= state.stereo_threshold)
    n_cand = s_matched.sum(dtype=torch.int32)
    avg = torch.where(s_matched, res, 0.0).sum() / n_cand.clamp(min=1).to(torch.float32)
    new_threshold = torch.where(n_cand > 0, avg + params.stereo_padding, state.stereo_threshold)

    # --- 4. Compact stereo survivors to the front (stable partition).
    perm = torch.argsort(torch.where(keep, 0, 1), stable=True)
    f_kps = l_kps[perm]
    f_desc = l_desc[perm]
    f_valid = keep[perm]
    f_right_kps = matched_r_kps[perm]
    num_features = f_valid.sum(dtype=torch.int32)

    # --- 5. Window matching: all W past frames vs the current frame.
    w_idx, w_dist, w_matched = match_window(
        state.desc, state.valid, f_desc, f_valid,
        params.nn_match_ratio, params.best_percent, mutual=mutual_check,
    )
    w_idx_l = w_idx.long()

    lu = undistort_points(params.intr_left, f_kps)

    # --- 5b. Odometry-guided gate: each window feature's stereo 3D point,
    # carried through odometry into the current camera, must reproject within
    # guided_radius px of its matched pixel; points without usable depth pass,
    # points predicted behind the camera are rejected.
    if curr_pose_t is not None:
        Rw = quat_to_matrix(state.pose_q)  # (W, 3, 3)
        p_robot = torch.einsum("ij,wkj->wki", params.cam_R, state.points3d) + params.cam_t
        X = torch.einsum("wij,wkj->wki", Rw, p_robot) + state.pose_t[:, None]
        Rc = quat_to_matrix(curr_pose_q)
        xr = torch.einsum("ji,wkj->wki", Rc, X - curr_pose_t)  # Rc^T (X - t)
        pc = torch.einsum("ji,wkj->wki", params.cam_R, xr - params.cam_t)
        z = pc[..., 2]
        zsafe = torch.where(z.abs() < 1e-6, 1e-6, z)
        intr = params.intr_left
        proj_u = intr.fx * pc[..., 0] / zsafe + intr.cx
        proj_v = intr.fy * pc[..., 1] / zsafe + intr.cy
        target = lu[w_idx_l]  # (W, K, 2)
        err2 = (proj_u - target[..., 0]) ** 2 + (proj_v - target[..., 1]) ** 2
        stored_valid = state.points3d[..., 2] > 0.1
        has_depth = stored_valid & (z > 0.1)
        behind = stored_valid & (z <= 0.0)
        ok = ((err2 <= params.guided_radius ** 2) | ~has_depth) & ~behind
        w_matched = w_matched & torch.where(params.guided_radius > 0, ok, torch.ones_like(ok))

    # --- 6. Track propagation: oldest match wins, then smallest distance.
    # One scatter-min of priority (slot * 1000 + dist), then the winners'
    # track ids. Where two winners claim one feature (an exact tie kept by
    # the one-to-one cut), the higher flat (w * K + q) position wins: the
    # reference's scatter lets the last write win on the CPU.
    tid = frame_id * K + torch.arange(K, dtype=torch.int32, device=dev)
    w_rows = torch.arange(W, dtype=torch.float32, device=dev)[:, None]
    prio = w_rows * 1000.0 + w_dist.clamp(max=999.0)  # (W, K)
    tgt = torch.where(w_matched, w_idx_l, K).reshape(-1)
    minp = torch.full((K + 1,), float("inf"), device=dev).scatter_reduce(
        0, tgt, prio.reshape(-1), reduce="amin", include_self=True
    )
    winner = w_matched & (prio == minp[tgt].reshape(W, K))
    wtgt = torch.where(winner, w_idx_l, K).reshape(-1)
    src = torch.full((K + 1,), -1, dtype=torch.int64, device=dev).scatter_reduce(
        0, wtgt, torch.arange(W * K, device=dev), reduce="amax", include_self=True
    )[:K]
    tid = torch.where(src >= 0, state.track_id.reshape(-1)[src.clamp(min=0)], tid)

    # --- 7. Triangulation on undistorted stereo pairs.
    ru = undistort_points(params.intr_right, f_right_kps)
    points3d = triangulate_points(params.P_left, params.P_right, lu, ru)
    points3d = torch.where(f_valid[:, None], points3d, 0.0)

    # --- 8. Node features: undistorted left pixels.
    pixels_undist = torch.where(f_valid[:, None], lu, 0.0)

    # --- 9. Window update: evict the oldest iff full, append the current
    # frame (roll, then write; slot 0 stays the oldest).
    full = state.count >= W
    write_sel = torch.arange(W, device=dev) == state.count.clamp(max=W - 1)

    def updated(buf, new_row):
        rolled = torch.where(full, torch.roll(buf, -1, dims=0), buf)
        sel = write_sel.reshape((W,) + (1,) * (buf.dim() - 1))
        return torch.where(sel, new_row.to(buf.dtype).unsqueeze(0), rolled)

    if curr_pose_t is None:
        curr_pose_t = torch.zeros(3, dtype=torch.float32, device=dev)
        curr_pose_q = torch.zeros(4, dtype=torch.float32, device=dev)
        curr_pose_q[0] = 1.0
    new_state = WindowState(
        kps=updated(state.kps, f_kps),
        desc=updated(state.desc, f_desc),
        valid=updated(state.valid, f_valid),
        track_id=updated(state.track_id, tid),
        frame_id=updated(state.frame_id, torch.full((), frame_id, dtype=torch.int32, device=dev)),
        count=(state.count + 1).clamp(max=W),
        stereo_threshold=new_threshold,
        points3d=updated(state.points3d, points3d),
        pose_t=updated(state.pose_t, curr_pose_t),
        pose_q=updated(state.pose_q, curr_pose_q),
    )

    result = KeyframeResult(
        pixels_undist=pixels_undist,
        pixels_raw=torch.where(f_valid[:, None], f_kps, 0.0),
        right_pixels_raw=torch.where(f_valid[:, None], f_right_kps, 0.0),
        right_pixels_undist=torch.where(f_valid[:, None], ru, 0.0),
        points3d=points3d,
        feat_valid=f_valid,
        track_id=tid,
        window_curr_idx=w_idx,
        window_match_dist=w_dist,
        window_matched=w_matched,
        window_frame_id=state.frame_id,
        num_features=num_features,
        num_stereo_candidates=n_cand,
        stereo_threshold=new_threshold,
    )
    return new_state, result
