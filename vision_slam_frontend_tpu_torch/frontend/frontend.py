"""Host-side Frontend: odometry gating + problem accumulation
(port of frontend/frontend.py).

The stateful shell around the keyframe step. It gates keyframes on
odometry, runs the step on its device, and turns the step's outputs into
the host-side SLAMProblem. Results are fetched one keyframe deep: right
after keyframe k is launched, its host-needed fields start copying into
pinned host memory behind a CUDA event, and they are read when keyframe
k + 1 arrives (or when an accessor asks), so the device never waits for the
host between keyframes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from vision_slam_frontend_tpu_torch.frontend.config import FrontendConfig
from vision_slam_frontend_tpu_torch.frontend.keyframe import (
    KeyframeResult,
    StepParams,
    WindowState,
    keyframe_step,
)
from vision_slam_frontend_tpu_torch.ops.descriptors import get_family
from vision_slam_frontend_tpu_torch.types.slam_types import (
    FeatureMatch,
    OdometryFactor,
    RobotPose,
    SLAMNode,
    SLAMProblem,
    VisionFactor,
    VisionFeature,
)
from vision_slam_frontend_tpu_torch.utils import np_geom

# KeyframeResult fields the host accumulator reads.
_HOST_FIELDS = (
    "pixels_undist", "right_pixels_undist", "points3d", "feat_valid", "track_id",
    "window_curr_idx", "window_matched", "window_frame_id", "num_features",
    "num_stereo_candidates", "stereo_threshold",
)


class Frontend:
    """Stateful stereo SLAM frontend on one torch device.

    Feed it odometry and stereo images; it emits a SLAMProblem."""

    def __init__(self, config: Optional[FrontendConfig | str] = None, *, device):
        if config is None or config == "":
            config = FrontendConfig()
        elif isinstance(config, str):
            config = FrontendConfig.load(config)
        self.config = config
        self.device = torch.device(device)
        self._params = StepParams.from_config(config, self.device)
        self._state = WindowState.create(
            config.frame_life, config.max_features, config.stereo_threshold_init,
            self.device, words=get_family(config.descriptor_family).words,
        )
        self._curr_frame_id = 0

        self._odom_initialized = False
        self._init_odom_t = np.zeros(3)
        self._init_odom_q = np.array([1.0, 0, 0, 0])
        self._prev_odom_t = np.zeros(3)
        self._prev_odom_q = np.array([1.0, 0, 0, 0])
        self._odom_t = np.zeros(3)
        self._odom_q = np.array([1.0, 0, 0, 0])
        self._odom_timestamp = 0.0

        self._nodes: List[SLAMNode] = []
        self._vision_factors: List[VisionFactor] = []
        self._odometry_factors: List[OdometryFactor] = []
        self._node_track_ids: List[np.ndarray] = []
        self._stats: List[dict] = []
        self.verbosity = 0
        # (host context, {field: host tensor}, CUDA event or None) of the
        # newest keyframe; every public accessor flushes it first.
        self._pending = None

    # ------------------------------------------------------------------
    # Observation API
    # ------------------------------------------------------------------

    def observe_odometry(self, translation: np.ndarray, rotation: np.ndarray, timestamp: float) -> None:
        """Latch the latest odometry pose. `rotation` is [w, x, y, z]."""
        translation = np.asarray(translation, np.float64)
        rotation = np_geom.quat_normalize(np.asarray(rotation, np.float64))
        if not self._odom_initialized:
            self._init_odom_t = translation.copy()
            self._init_odom_q = rotation.copy()
            self._prev_odom_t = translation.copy()
            self._prev_odom_q = rotation.copy()
            self._odom_initialized = True
        self._odom_t = translation
        self._odom_q = rotation
        self._odom_timestamp = float(timestamp)

    def _odom_check(self) -> bool:
        """Keyframe gate: moved more than min_odom_translation or rotated
        more than min_odom_rotation since the last keyframe."""
        if not self._odom_initialized:
            return False
        if np.linalg.norm(self._prev_odom_t - self._odom_t) > self.config.min_odom_translation:
            return True
        return np_geom.quat_angular_distance(self._prev_odom_q, self._odom_q) > self.config.min_odom_rotation

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting for the device:
        pinned staging and an asynchronous copy on CUDA."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _as_u8(self, img) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            if img.dtype != torch.uint8 or img.device != self.device:
                raise ValueError(
                    f"image tensors must be uint8 on {self.device}, got {img.dtype} on {img.device}"
                )
            return img
        return self._to_device(np.clip(np.asarray(img), 0, 255).astype(np.uint8))

    def observe_image(self, left_image, right_image, time: float) -> bool:
        """Process a stereo pair (numpy arrays, or uint8 tensors already on
        the device); returns True iff a new SLAM node was added."""
        if not self._odom_check():
            return False
        fid = self._curr_frame_id
        # Odometry-estimated world pose of this keyframe (feeds the guided gate).
        q_init_inv = np_geom.quat_inverse(self._init_odom_q)
        pose_t = np_geom.quat_rotate(q_init_inv, self._odom_t - self._init_odom_t)
        pose_q = np_geom.quat_multiply(self._odom_q, q_init_inv)
        pose = self._to_device(np.concatenate([pose_t, pose_q]).astype(np.float32))

        self._state, result = keyframe_step(
            self._params,
            self._state,
            self._as_u8(left_image),
            self._as_u8(right_image),
            fid,
            capacity=self.config.max_features,
            window=self.config.frame_life,
            border=self.config.detect_border,
            blur_sigma=self.config.blur_sigma,
            num_levels=self.config.num_levels,
            descriptor_family=self.config.descriptor_family,
            mutual_check=self.config.mutual_check,
            curr_pose_t=pose[:3],
            curr_pose_q=pose[3:],
        )
        ctx = {
            "fid": fid,
            "timestamp": self._odom_timestamp,
            "odom_t": self._odom_t.copy(),
            "odom_q": self._odom_q.copy(),
            "prev_odom_t": self._prev_odom_t.copy(),
            "prev_odom_q": self._prev_odom_q.copy(),
        }
        # Pipeline one deep: materialize keyframe k-1 while k computes.
        self._flush_pending()
        host = {f: getattr(result, f).to("cpu", non_blocking=True) for f in _HOST_FIELDS}
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
        self._pending = (ctx, host, event)
        self._prev_odom_t = self._odom_t.copy()
        self._prev_odom_q = self._odom_q.copy()
        self._curr_frame_id += 1
        return True

    def _flush_pending(self) -> None:
        if self._pending is None:
            return
        ctx, host, event = self._pending
        self._pending = None
        if event is not None:
            event.synchronize()
        fields = dict.fromkeys(f.name for f in dataclasses.fields(KeyframeResult))
        fields.update({k: v.numpy() for k, v in host.items()})
        self._materialize(ctx, KeyframeResult(**fields))

    def _materialize(self, ctx: dict, r: KeyframeResult) -> None:
        fid = ctx["fid"]
        self._accumulate(fid, r, ctx)
        matched_per_slot = np.asarray(r.window_matched).sum(axis=1)
        self._stats.append(
            {
                "frame_id": fid,
                "timestamp": ctx["timestamp"],
                "num_features": int(r.num_features),
                "num_stereo_candidates": int(r.num_stereo_candidates),
                "stereo_threshold": float(r.stereo_threshold),
                "window_matches": matched_per_slot.tolist(),
            }
        )
        if self.verbosity > 1:
            print(
                f"[frontend] keyframe {fid}: {int(r.num_features)} features "
                f"({int(r.num_stereo_candidates)} stereo candidates, "
                f"epipolar gate {float(r.stereo_threshold):.1f}), window matches "
                f"{matched_per_slot.tolist()}"
            )

    def _accumulate(self, fid: int, r: KeyframeResult, ctx: dict) -> None:
        """Convert one keyframe's outputs into problem entries."""
        n = int(r.num_features)
        feats = [
            VisionFeature(
                i,
                r.pixels_undist[i].copy(),
                r.points3d[i].copy(),
                pixel_right=r.right_pixels_undist[i].copy(),
            )
            for i in range(n)
        ]
        # World pose relative to the odometry start.
        q_init_inv = np_geom.quat_inverse(self._init_odom_q)
        loc = np_geom.quat_rotate(q_init_inv, ctx["odom_t"] - self._init_odom_t)
        angle = np_geom.quat_multiply(ctx["odom_q"], q_init_inv)
        self._nodes.append(
            SLAMNode(
                node_idx=fid,
                timestamp=ctx["timestamp"],
                pose=RobotPose(loc=loc.astype(np.float32), angle=angle.astype(np.float32)),
                features=feats,
            )
        )
        self._node_track_ids.append(np.asarray(r.track_id[:n]).copy())

        # Vision factors: one per filled window slot, oldest first, even if empty.
        for w in range(self.config.frame_life):
            past_id = int(r.window_frame_id[w])
            if past_id < 0:
                continue
            qs = np.nonzero(r.window_matched[w])[0]
            matches = [FeatureMatch(int(q), int(r.window_curr_idx[w][q])) for q in qs]
            self._vision_factors.append(
                VisionFactor(pose_idx_initial=past_id, pose_idx_current=fid, feature_matches=matches)
            )

        # Odometry factor between consecutive keyframes.
        if fid > 0:
            q_prev_inv = np_geom.quat_inverse(ctx["prev_odom_q"])
            self._odometry_factors.append(
                OdometryFactor(
                    pose_i=fid - 1,
                    pose_j=fid,
                    translation=np_geom.quat_rotate(
                        q_prev_inv, ctx["odom_t"] - ctx["prev_odom_t"]
                    ).astype(np.float32),
                    rotation=np_geom.quat_multiply(ctx["odom_q"], q_prev_inv).astype(np.float32),
                )
            )

    # ------------------------------------------------------------------
    # Output API
    # ------------------------------------------------------------------

    def get_slam_problem(self) -> SLAMProblem:
        self._flush_pending()
        return SLAMProblem(
            nodes=list(self._nodes),
            vision_factors=list(self._vision_factors),
            odometry_factors=list(self._odometry_factors),
        )

    def get_num_poses(self) -> int:
        self._flush_pending()
        return len(self._nodes)

    def update_poses(self, nodes_or_t, poses_q=None) -> int:
        """Write refined poses back into the accumulated problem: a list of
        SLAMNodes (copied by node_idx), or arrays (poses_t (N, 3), poses_q
        (N, 4)) in node order. Returns the number of poses updated."""
        self._flush_pending()
        if poses_q is None:
            by_idx = {n.node_idx: n for n in self._nodes}
            count = 0
            for src in nodes_or_t:
                dst = by_idx.get(src.node_idx)
                if dst is None:
                    continue
                dst.pose.loc = np.asarray(src.pose.loc, np.float32).copy()
                dst.pose.angle = np.asarray(src.pose.angle, np.float32).copy()
                count += 1
            return count
        poses_t = np.asarray(nodes_or_t, np.float32)
        poses_q = np.asarray(poses_q, np.float32)
        if len(poses_t) != len(self._nodes) or len(poses_q) != len(self._nodes):
            raise ValueError(
                f"pose arrays ({len(poses_t)}, {len(poses_q)}) do not match "
                f"{len(self._nodes)} nodes"
            )
        for node, t, q in zip(self._nodes, poses_t, poses_q):
            node.pose.loc = t.copy()
            node.pose.angle = q.copy()
        return len(self._nodes)

    @property
    def node_track_ids(self) -> List[np.ndarray]:
        """Per-node persistent track ids."""
        self._flush_pending()
        return self._node_track_ids

    @property
    def stats(self) -> List[dict]:
        """Per-keyframe statistics (features, stereo survival, adaptive
        threshold, window match counts)."""
        self._flush_pending()
        return self._stats

    def stats_summary(self) -> dict:
        self._flush_pending()
        if not self._stats:
            return {}
        feats = [s["num_features"] for s in self._stats]
        cands = [s["num_stereo_candidates"] for s in self._stats]
        return {
            "keyframes": len(self._stats),
            "features_mean": float(np.mean(feats)),
            "features_min": int(np.min(feats)),
            "stereo_survival_mean": float(np.mean([f / max(c, 1) for f, c in zip(feats, cands)])),
            "stereo_threshold_last": self._stats[-1]["stereo_threshold"],
        }
