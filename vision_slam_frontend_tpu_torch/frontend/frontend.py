"""Host-side Frontend: odometry gating + problem accumulation
(port of frontend/frontend.py).

The stateful shell around the keyframe step. It gates keyframes on
odometry, runs the step on its device, and turns the step's outputs into
the host-side SLAMProblem. Results are fetched one keyframe deep: right
after keyframe k is launched, its host-needed fields start copying into
pinned host memory behind a CUDA event, and they are read when keyframe
k + 1 arrives (or when an accessor asks), so the device never waits for the
host between keyframes. With `validate` the fetch is synchronous instead, and
each keyframe is checked (utils/checks.check_keyframe_result) before it is
accumulated. With `debug_images` the raw pixels and host copies of the two
images ride in the same pending slot, and each keyframe's debug entry is
handed to `debug_sink` (viz/live.DebugImageStreamer writes PNGs) when the
keyframe is materialized, or buffered for `get_debug_data`.
`save_checkpoint` / `load_checkpoint` write and read the JAX package's
checkpoint npz, so a run checkpointed by either package resumes in the other.
Each keyframe's observe (upload, step, fetch) and each flush (its wait and
the accumulation) are spans (utils/profiling.span) whose request is the
keyframe's frame id.

On CUDA the step is replayed from a CUDA graph, one per static key
(`step_key`: the step's settings and the image shape), made by
utils/cuda_graph.CapturedCall (layer `keyframe`): a key's first keyframe
steps eagerly, its second is captured and every keyframe from then on is
one replay. The window is the Frontend's own WindowState, into which every
step copies its new window (`_step`), so the graphs read and write it and
`_state` is always the current window. The CPU runs the eager step.
"""

from __future__ import annotations

import dataclasses
import os
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
from vision_slam_frontend_tpu_torch.io.serialize import arrays_to_problem, problem_to_arrays
from vision_slam_frontend_tpu_torch.ops.descriptors import descriptor_dtype, get_family
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
from vision_slam_frontend_tpu_torch.utils.checks import check_keyframe_result
from vision_slam_frontend_tpu_torch.utils.cuda_graph import CapturedCall
from vision_slam_frontend_tpu_torch.utils.profiling import span

# KeyframeResult fields the host accumulator reads.
_HOST_FIELDS = (
    "pixels_undist", "right_pixels_undist", "points3d", "feat_valid", "track_id",
    "window_curr_idx", "window_matched", "window_frame_id", "num_features",
    "num_stereo_candidates", "stereo_threshold",
)
# ... and, in validate or debug-image mode, the raw pixels (the checks bound
# them to the image; viz/debug_images draws them).
_VALIDATE_FIELDS = _HOST_FIELDS + ("pixels_raw", "right_pixels_raw")


def step_key(config: FrontendConfig, device, image_shape) -> tuple:
    """What a captured keyframe step is specialised to: one CUDA graph per
    distinct key. (The Frontend always gives the step a pose, so the guided
    gate is always in the graph.)"""
    return (torch.device(device), config.descriptor_family.lower(), config.max_features, config.frame_life,
            config.detect_border, config.blur_sigma, config.num_levels, config.pyramid_scale,
            config.mutual_check, tuple(image_shape))


class _StepGraph:
    """The keyframe step of one key as a CUDA graph: its static inputs (the
    two images, the pose, the frame id), written before each step."""

    def __init__(self, device: torch.device, image_shape):
        self.left = torch.empty(image_shape, dtype=torch.uint8, device=device)
        self.right = torch.empty_like(self.left)
        self.pose = torch.empty(7, dtype=torch.float32, device=device)
        self.frame_id = torch.zeros((), dtype=torch.int32, device=device)
        self.call = CapturedCall("keyframe")

    def run(self, step, frame_id: int) -> KeyframeResult:
        """`step` on the static inputs, the frame id written into its
        device scalar first; the result is the graph's static output from
        the key's second keyframe on."""
        self.frame_id.fill_(frame_id)
        return self.call(lambda: step(self.left, self.right, self.pose, self.frame_id), frame_id)


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
        family = get_family(config.descriptor_family)
        self._state = WindowState.create(
            config.frame_life, config.max_features, config.stereo_threshold_init,
            self.device, words=family.words, desc_dtype=descriptor_dtype(family),
        )
        self._curr_frame_id = 0
        self._graphs: dict[tuple, _StepGraph] = {}  # CUDA only, by step_key

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
        self._debug_data: List[dict] = []
        self.verbosity = 0
        # (host context, {field: host tensor}, CUDA event or None) of the
        # newest keyframe; every public accessor flushes it first.
        self._pending = None
        # With debug_images: callable(entry, frontend) taking each keyframe's
        # debug entry as it is materialized instead of buffering it, so
        # memory stays flat on long runs.
        self.debug_sink = None

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

    def _to_device(self, array: np.ndarray, out: torch.Tensor | None = None) -> torch.Tensor:
        """Host array -> device tensor (or into `out`) without waiting for
        the device: pinned staging and an asynchronous copy on CUDA."""
        t = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type != "cuda":
            return t.to(self.device)
        t = t.pin_memory()
        return t.to(self.device, non_blocking=True) if out is None else out.copy_(t, non_blocking=True)

    def _as_u8(self, img, out: torch.Tensor | None = None) -> torch.Tensor:
        if isinstance(img, torch.Tensor):
            if img.dtype != torch.uint8 or img.device != self.device:
                raise ValueError(
                    f"image tensors must be uint8 on {self.device}, got {img.dtype} on {img.device}"
                )
            return img if out is None else out.copy_(img)
        return self._to_device(np.clip(np.asarray(img), 0, 255).astype(np.uint8), out)

    def _step(self, left, right, pose, frame_id) -> KeyframeResult:
        """The keyframe step with the new window written into the
        Frontend's own window tensors, so a CUDA graph of it reads and writes
        the same buffers on every replay. The result's `window_frame_id` is
        a copy of the pre-update row, taken before the write."""
        c = self.config
        new_state, result = keyframe_step(
            self._params, self._state, left, right, frame_id,
            capacity=c.max_features, window=c.frame_life, border=c.detect_border, blur_sigma=c.blur_sigma,
            num_levels=c.num_levels, scale_factor=c.pyramid_scale, descriptor_family=c.descriptor_family,
            mutual_check=c.mutual_check, curr_pose_t=pose[:3], curr_pose_q=pose[3:],
        )
        result.window_frame_id = result.window_frame_id.clone()
        self._state.copy_(new_state)
        return result

    def observe_image(self, left_image, right_image, time: float) -> bool:
        """Process a stereo pair (numpy arrays, or uint8 tensors already on
        the device); returns True iff a new SLAM node was added."""
        if not self._odom_check():
            return False
        fid = self._curr_frame_id
        with span("frontend.observe", fid):
            with span("frontend.upload"):
                # Odometry-estimated world pose of this keyframe (feeds the guided gate).
                q_init_inv = np_geom.quat_inverse(self._init_odom_q)
                pose_t = np_geom.quat_rotate(q_init_inv, self._odom_t - self._init_odom_t)
                pose_q = np_geom.quat_multiply(self._odom_q, q_init_inv)
                pose = np.concatenate([pose_t, pose_q]).astype(np.float32)
                graph = None
                if self.device.type == "cuda":
                    shape = tuple(np.shape(left_image)[:2])
                    key = step_key(self.config, self.device, shape)
                    if key not in self._graphs:
                        self._graphs[key] = _StepGraph(self.device, shape)
                    graph = self._graphs[key]
                    self._as_u8(left_image, graph.left)
                    self._as_u8(right_image, graph.right)
                    self._to_device(pose, graph.pose)
                else:
                    inputs = (self._as_u8(left_image), self._as_u8(right_image), self._to_device(pose))

            with span("keyframe.step"):
                result = self._step(*inputs, fid) if graph is None else graph.run(self._step, fid)
            ctx = {
                "fid": fid,
                "timestamp": self._odom_timestamp,
                "odom_t": self._odom_t.copy(),
                "odom_q": self._odom_q.copy(),
                "prev_odom_t": self._prev_odom_t.copy(),
                "prev_odom_q": self._prev_odom_q.copy(),
                "image_shape": tuple(np.shape(left_image)[:2]),
            }
            if self.config.debug_images:
                ctx["left_image"] = self._host_image(left_image)
                ctx["right_image"] = self._host_image(right_image)
            # Pipeline one deep: materialize keyframe k-1 while k computes.
            self._flush_pending()
            with span("frontend.fetch"):
                raw = self.config.validate or self.config.debug_images
                fields = _VALIDATE_FIELDS if raw else _HOST_FIELDS
                host = {f: getattr(result, f).to("cpu", non_blocking=True) for f in fields}
                event = None
                if self.device.type == "cuda":
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(self.device))
                self._pending = (ctx, host, event)
            if self.config.validate:
                # Validation reports the error at the offending keyframe: synchronous.
                self._flush_pending()
        self._prev_odom_t = self._odom_t.copy()
        self._prev_odom_q = self._odom_q.copy()
        self._curr_frame_id += 1
        return True

    @staticmethod
    def _host_image(img):
        """A debug copy of an input image: the array itself for host input
        (drawn as the JAX package draws it); for a device tensor, a
        non-blocking copy into pinned memory that the pending slot's event
        covers."""
        if not isinstance(img, torch.Tensor):
            return np.asarray(img)
        if img.device.type == "cpu":
            return img.numpy().copy()
        return img.to("cpu", non_blocking=True)

    def _flush_pending(self) -> None:
        if self._pending is None:
            return
        ctx, host, event = self._pending
        self._pending = None
        with span("frontend.flush", ctx["fid"]):
            if event is not None:
                with span("frontend.flush.wait"):
                    event.synchronize()
            for key in ("left_image", "right_image"):
                if isinstance(ctx.get(key), torch.Tensor):
                    ctx[key] = ctx[key].numpy()
            fields = dict.fromkeys(f.name for f in dataclasses.fields(KeyframeResult))
            fields.update({k: v.numpy() for k, v in host.items()})
            with span("frontend.accumulate"):
                self._materialize(ctx, KeyframeResult(**fields))

    def _materialize(self, ctx: dict, r: KeyframeResult) -> None:
        fid = ctx["fid"]
        if self.config.validate:
            check_keyframe_result(fid, r, ctx["image_shape"], self.config.max_features)
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
        if self.config.debug_images:
            entry = {"frame_id": fid, "left_image": ctx["left_image"], "right_image": ctx["right_image"], "result": r}
            if self.debug_sink is not None:
                self.debug_sink(entry, self)
            else:
                self._debug_data.append(entry)

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
    # Checkpoint / resume
    # ------------------------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        """Snapshot the whole frontend state (the accumulated problem, the
        window state, the odometry latch, the frame counter) in the JAX
        package's keys and dtypes: packed descriptor words as uint32, float
        descriptors as float32. Written through `<path>.tmp`, then renamed."""
        self._flush_pending()
        data = problem_to_arrays(self.get_slam_problem(), self._node_track_ids)
        state = {f.name: getattr(self._state, f.name).cpu().numpy() for f in dataclasses.fields(self._state)}
        desc = state["desc"]
        data.update({
            "ckpt_window_kps": state["kps"],
            "ckpt_window_desc": desc.view(np.uint32) if desc.dtype == np.int32 else desc,
            "ckpt_window_valid": state["valid"],
            "ckpt_window_track_id": state["track_id"],
            "ckpt_window_frame_id": state["frame_id"],
            "ckpt_window_count": state["count"],
            "ckpt_stereo_threshold": state["stereo_threshold"],
            "ckpt_window_points3d": state["points3d"],
            "ckpt_window_pose_t": state["pose_t"],
            "ckpt_window_pose_q": state["pose_q"],
            "ckpt_curr_frame_id": np.int64(self._curr_frame_id),
            "ckpt_odom_initialized": np.bool_(self._odom_initialized),
            "ckpt_init_odom_t": self._init_odom_t,
            "ckpt_init_odom_q": self._init_odom_q,
            "ckpt_prev_odom_t": self._prev_odom_t,
            "ckpt_prev_odom_q": self._prev_odom_q,
            "ckpt_odom_t": self._odom_t,
            "ckpt_odom_q": self._odom_q,
            "ckpt_odom_timestamp": np.float64(self._odom_timestamp),
        })
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:  # a file object: savez appends no ".npz"
            np.savez_compressed(f, **data)
        os.replace(tmp, path)

    def load_checkpoint(self, path: str) -> float:
        """Restore a state saved by either package's save_checkpoint; returns
        the last odometry timestamp it had seen (callers skip events at or
        before it). Window fields a checkpoint lacks (points, poses: older
        checkpoints) start empty, as in the JAX package."""
        with np.load(path) as raw:
            data = dict(raw)
        self._pending = None
        problem = arrays_to_problem(data)
        self._nodes = problem.nodes
        self._vision_factors = problem.vision_factors
        self._odometry_factors = problem.odometry_factors
        if "feat_track" in data and len(self._nodes):
            flat = data["feat_track"]
            self._node_track_ids = []
            off = 0
            for n in self._nodes:
                k = len(n.features)
                self._node_track_ids.append(flat[off : off + k].copy())
                off += k
        W, K = data["ckpt_window_kps"].shape[:2]
        data.setdefault("ckpt_window_points3d", np.zeros((W, K, 3), np.float32))
        data.setdefault("ckpt_window_pose_t", np.zeros((W, 3), np.float32))
        data.setdefault("ckpt_window_pose_q", np.tile(np.array([1.0, 0, 0, 0], np.float32), (W, 1)))
        state = WindowState.from_numpy(data, self.device)
        if state.desc.shape != self._state.desc.shape or state.desc.dtype != self._state.desc.dtype:
            raise ValueError(
                f"checkpoint {path}: window descriptors {tuple(state.desc.shape)} {state.desc.dtype}, but this "
                f"frontend ({self.config.descriptor_family}) keeps {tuple(self._state.desc.shape)} "
                f"{self._state.desc.dtype}"
            )
        self._state.copy_(state)  # in place: the captured steps read and write these tensors
        self._curr_frame_id = int(data["ckpt_curr_frame_id"])
        self._odom_initialized = bool(data["ckpt_odom_initialized"])
        self._init_odom_t = data["ckpt_init_odom_t"]
        self._init_odom_q = data["ckpt_init_odom_q"]
        self._prev_odom_t = data["ckpt_prev_odom_t"]
        self._prev_odom_q = data["ckpt_prev_odom_q"]
        self._odom_t = data["ckpt_odom_t"]
        self._odom_q = data["ckpt_odom_q"]
        self._odom_timestamp = float(data["ckpt_odom_timestamp"])
        return self._odom_timestamp

    # ------------------------------------------------------------------
    # Output API
    # ------------------------------------------------------------------

    def peek_accumulated(self):
        """(nodes, vision_factors, odometry_factors) as materialized so far,
        without flushing the pipeline: one keyframe behind the device at
        most. The live viewer reads its deltas here."""
        return self._nodes, self._vision_factors, self._odometry_factors

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

    def get_config(self) -> FrontendConfig:
        return self.config

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

    def get_debug_data(self) -> List[dict]:
        """The buffered debug entries (empty while a debug_sink is set)."""
        self._flush_pending()
        return self._debug_data

    def get_last_debug_data(self) -> Optional[dict]:
        self._flush_pending()
        return self._debug_data[-1] if self._debug_data else None
