"""SLAMProblem -> BAProblem: chain matches into landmark tracks (port of
backend/tracks.py; numpy on the host, the same arrays as the JAX package's).

A frontend's vision factors are pairwise match lists between poses; a bundle
adjuster needs landmarks. This module chains the pairwise matches into
tracks with a host-side union-find (transitive closure over (pose, feature)
nodes), initializes each landmark from the first observation's triangulated
stereo point lifted to the world frame, and emits the flat fixed-capacity
BAProblem tensors the solver consumes, on the requested device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from vision_slam_frontend_tpu_torch.types.slam_types import BAProblem, SLAMProblem
from vision_slam_frontend_tpu_torch.utils import np_geom
from vision_slam_frontend_tpu_torch.utils.device import resolve_device


def build_gather_tables(
    obs_pose: np.ndarray,
    obs_landmark: np.ndarray,
    obs_mask: np.ndarray,
    num_poses: int,
    num_landmarks: int,
    pad_multiple: int = 8,
):
    """Precompute the solver's segment-reduction plan as padded index tables.

    `sum over observations of pose p` is computed as a dense gather over
    `pose_obs[p]` + masked sum: no scatter, so the sums are deterministic on
    the GPU. Built once per problem on the host (the observation graph is
    static during a solve).

    Returns (pose_obs, pose_obs_mask, lm_obs, lm_obs_mask).
    """
    obs_pose = np.asarray(obs_pose)
    obs_landmark = np.asarray(obs_landmark)
    obs_mask = np.asarray(obs_mask)

    def table(ids, num_segments):
        idx_valid = np.nonzero(obs_mask)[0]
        order = np.argsort(ids[idx_valid], kind="stable")
        sorted_idx = idx_valid[order]
        sorted_ids = ids[idx_valid][order]
        counts = np.bincount(sorted_ids, minlength=num_segments)
        width = int(counts.max()) if len(counts) and counts.max() > 0 else 1
        width = ((width + pad_multiple - 1) // pad_multiple) * pad_multiple
        tbl = np.zeros((num_segments, width), np.int32)
        msk = np.zeros((num_segments, width), bool)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        for s in range(num_segments):
            c = counts[s]
            if c:
                tbl[s, :c] = sorted_idx[starts[s] : starts[s] + c]
                msk[s, :c] = True
        return tbl, msk

    pose_obs, pose_obs_mask = table(obs_pose, num_poses)
    lm_obs, lm_obs_mask = table(obs_landmark, num_landmarks)
    # Translate the landmark table into POSE-MAJOR flat positions: the solver
    # lays observation tensors out as (P, Mp, ...) so pose-side products are
    # gather-free; landmark reductions then index that flat (P*Mp) space.
    Mp = pose_obs.shape[1]
    obs_to_pm = np.zeros(max(int(obs_pose.shape[0]), 1), np.int64)
    rows = np.repeat(np.arange(pose_obs.shape[0]), Mp)
    cols = np.tile(np.arange(Mp), pose_obs.shape[0])
    flat_idx = pose_obs.reshape(-1)
    valid = pose_obs_mask.reshape(-1)
    obs_to_pm[flat_idx[valid]] = (rows * Mp + cols)[valid]
    lm_obs_pm = obs_to_pm[lm_obs].astype(np.int32)
    lm_obs_pm[~lm_obs_mask] = 0
    return pose_obs, pose_obs_mask, lm_obs_pm, lm_obs_mask


class _UnionFind:
    def __init__(self):
        self.parent = {}

    def find(self, x):
        p = self.parent.setdefault(x, x)
        if p != x:
            self.parent[x] = p = self.find(p)
        return p

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[ra] = rb


def build_ba_problem(
    problem: SLAMProblem,
    left_cam_to_robot: Optional[np.ndarray] = None,
    min_track_length: int = 2,
    max_landmarks: Optional[int] = None,
    pad_to_multiple: int = 128,
    consistency_threshold: float = 0.75,
    device="cuda",
) -> BAProblem:
    """Convert a SLAMProblem to flat BA arrays.

    Args:
      problem: the frontend's output.
      left_cam_to_robot: 4x4 camera->robot transform (observations are
        left-camera pixels; the solver projects world points through
        pose o extrinsic).
      min_track_length: drop tracks observed fewer than this many times
        (single-observation landmarks don't constrain anything).
      max_landmarks: optional cap, keeping the longest tracks.
      pad_to_multiple: pad capacities to static shapes.
      consistency_threshold: geometric track verification (metres; <= 0
        disables). Ratio-test survivors on self-similar texture still chain
        FALSE matches into one union-find track (two different physical
        points merged), which poisons BA far beyond what Huber/trimming can
        absorb. Each observation carries its own stereo-triangulated 3D
        point; lifting them to world through the (odometry) poses, a true
        track's points agree to odometry-drift + stereo noise. Observations
        farther than `consistency_threshold * max(1, depth/5)` from the
        track's component-wise median are dropped (as are duplicate
        observations of one pose — keep the closest to the median).
      device: where the BAProblem's tensors go (default cuda; raises where
        there is no GPU).

    Returns a BAProblem of tensors on `device`.
    """
    device = resolve_device(device)
    return BAProblem.from_numpy(
        build_ba_arrays(problem, left_cam_to_robot, min_track_length, max_landmarks, pad_to_multiple,
                        consistency_threshold),
        device=device,
    )


def build_ba_arrays(
    problem: SLAMProblem,
    left_cam_to_robot: Optional[np.ndarray] = None,
    min_track_length: int = 2,
    max_landmarks: Optional[int] = None,
    pad_to_multiple: int = 128,
    consistency_threshold: float = 0.75,
    gather_tables: bool = True,
) -> dict:
    """build_ba_problem's arrays in numpy ({field: array}, index fields
    int32, the JAX package's dtypes), before any upload; without the gather
    tables when `gather_tables` is False (the scatter-form solves)."""
    uf = _UnionFind()
    for f in problem.vision_factors:
        for m in f.feature_matches:
            uf.union(
                (f.pose_idx_initial, m.feature_idx_initial),
                (f.pose_idx_current, m.feature_idx_current),
            )

    # Collect observations per track root.
    tracks: dict = {}
    node_by_id = {n.node_idx: n for n in problem.nodes}
    for f in problem.vision_factors:
        for m in f.feature_matches:
            for key in (
                (f.pose_idx_initial, m.feature_idx_initial),
                (f.pose_idx_current, m.feature_idx_current),
            ):
                root = uf.find(key)
                tracks.setdefault(root, set()).add(key)

    track_list = [sorted(obs) for obs in tracks.values() if len(obs) >= min_track_length]
    # Longest tracks first (most informative), deterministic tie-break.
    track_list.sort(key=lambda t: (-len(t), t[0]))

    pose_ids = np.array(sorted(node_by_id), np.int64)
    pose_row = {pid: i for i, pid in enumerate(pose_ids)}
    P = len(pose_ids)

    if left_cam_to_robot is None:
        left_cam_to_robot = np.eye(4)
    R_cr = left_cam_to_robot[:3, :3]
    t_cr = left_cam_to_robot[:3, 3]

    # World points for ALL of a node's features in one batched matmul, not
    # one quat_rotate per observation (local BA calls this per keyframe).
    _world_cache: dict = {}

    def _node_world(node):
        if id(node) not in _world_cache:
            if not node.features:
                _world_cache[id(node)] = (np.zeros((0, 3)), np.zeros(0, bool))
            else:
                p3 = np.stack(
                    [np.asarray(f.point3d, np.float64) for f in node.features]
                )
                ok = np.all(np.isfinite(p3), axis=1) & (p3[:, 2] > 0.05)
                q = np_geom.quat_normalize(np.asarray(node.pose.angle, np.float64))
                w, x, y, z = q
                R = np.array([
                    [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                ])
                pts = (np.nan_to_num(p3) @ R_cr.T + t_cr) @ R.T + np.asarray(
                    node.pose.loc, np.float64
                )
                _world_cache[id(node)] = (pts, ok)
        return _world_cache[id(node)]

    def world_point(pose_id, feat_idx):
        node = node_by_id.get(pose_id)
        if node is None or feat_idx >= len(node.features):
            return None
        pts, ok = _node_world(node)
        return pts[feat_idx] if ok[feat_idx] else None

    if consistency_threshold > 0:
        filtered = []
        for track in track_list:
            pts, keys = [], []
            for key in track:
                w = world_point(*key)
                if w is not None:
                    pts.append(w)
                    keys.append(key)
            if len(pts) < 2:
                # No geometric evidence either way (features without finite
                # stereo triangulations): absence of evidence is not
                # inconsistency — keep the track as-is; BA estimates the
                # landmark from the pixels regardless.
                filtered.append(track)
                continue
            if len(pts) < min_track_length:
                continue
            pts = np.stack(pts)
            med = np.median(pts, axis=0)
            d = np.linalg.norm(pts - med, axis=1)
            node0 = node_by_id[keys[0][0]]
            depth = np.linalg.norm(med - np.asarray(node0.pose.loc, np.float64))
            thr = consistency_threshold * max(1.0, depth / 5.0)
            # Keep consistent observations; at most one per pose (a
            # union-find track with two features in the SAME pose is a
            # guaranteed false merge — keep the one nearest the median).
            best: dict = {}
            for i, key in enumerate(keys):
                if d[i] > thr:
                    continue
                pid = key[0]
                if pid not in best or d[i] < d[best[pid]]:
                    best[pid] = i
            sel = sorted(keys[i] for i in best.values())
            if len(sel) >= min_track_length:
                filtered.append(sel)
        track_list = filtered

    if max_landmarks is not None:
        track_list = track_list[:max_landmarks]
    # Landmark ids in first-observed-pose order (the JAX package's order:
    # frontend tracks are pose-local, and its banded coupling plan keys off
    # this; the landmark ids must match it).
    track_list.sort(key=lambda t: t[0])

    obs_pose, obs_landmark, obs_pixel = [], [], []
    obs_pixel_right, obs_right = [], []
    landmarks = []
    for lid, track in enumerate(track_list):
        init = None
        for pose_id, feat_idx in track:
            node = node_by_id.get(pose_id)
            if node is None or feat_idx >= len(node.features):
                continue
            feat = node.features[feat_idx]
            obs_pose.append(pose_row[pose_id])
            obs_landmark.append(lid)
            obs_pixel.append(np.asarray(feat.pixel, np.float64))
            pr = getattr(feat, "pixel_right", None)
            if pr is not None and np.all(np.isfinite(pr)):
                obs_pixel_right.append(np.asarray(pr, np.float64))
                obs_right.append(True)
            else:
                obs_pixel_right.append(np.zeros(2))
                obs_right.append(False)
            if init is None and np.all(np.isfinite(feat.point3d)) and feat.point3d[2] > 0.05:
                # Lift the stereo-triangulated camera-frame point to world:
                # world = pose o (cam->robot) applied to point3d.
                p_robot = R_cr @ np.asarray(feat.point3d, np.float64) + t_cr
                q = np.asarray(node.pose.angle, np.float64)
                init = np_geom.quat_rotate(q, p_robot) + np.asarray(node.pose.loc, np.float64)
        landmarks.append(init if init is not None else np.zeros(3))

    L = len(landmarks)
    N = len(obs_pose)

    def cap(n):
        m = pad_to_multiple
        return max(m, ((n + m - 1) // m) * m)

    Pc, Lc, Nc = P, cap(L), cap(N)

    poses_t = np.zeros((Pc, 3), np.float32)
    poses_q = np.zeros((Pc, 4), np.float32)
    poses_q[:, 0] = 1.0
    pose_mask = np.zeros(Pc, bool)
    for pid in pose_ids:
        i = pose_row[pid]
        node = node_by_id[pid]
        poses_t[i] = node.pose.loc
        poses_q[i] = node.pose.angle
        pose_mask[i] = True

    lm = np.zeros((Lc, 3), np.float32)
    lm_mask = np.zeros(Lc, bool)
    if L:
        lm[:L] = np.stack(landmarks)
        lm_mask[:L] = True

    op = np.zeros(Nc, np.int32)
    ol = np.zeros(Nc, np.int32)
    opix = np.zeros((Nc, 2), np.float32)
    omask = np.zeros(Nc, bool)
    opix_r = np.zeros((Nc, 2), np.float32)
    omask_r = np.zeros(Nc, bool)
    if N:
        op[:N] = obs_pose
        ol[:N] = obs_landmark
        opix[:N] = np.stack(obs_pixel)
        omask[:N] = True
        opix_r[:N] = np.stack(obs_pixel_right)
        omask_r[:N] = obs_right

    Q = len(problem.odometry_factors)
    Qc = max(1, Q)
    oi = np.zeros(Qc, np.int32)
    oj = np.zeros(Qc, np.int32)
    ot = np.zeros((Qc, 3), np.float32)
    oq = np.zeros((Qc, 4), np.float32)
    oq[:, 0] = 1.0
    oqm = np.zeros(Qc, bool)
    for k, f in enumerate(problem.odometry_factors):
        if f.pose_i in pose_row and f.pose_j in pose_row:
            oi[k] = pose_row[f.pose_i]
            oj[k] = pose_row[f.pose_j]
            ot[k] = f.translation
            oq[k] = f.rotation
            oqm[k] = True

    arrays = dict(
        poses_t=poses_t,
        poses_q=poses_q,
        pose_mask=pose_mask,
        landmarks=lm,
        landmark_mask=lm_mask,
        obs_pose=op,
        obs_landmark=ol,
        obs_pixel=opix,
        obs_mask=omask,
        obs_pixel_right=opix_r,
        obs_right_mask=omask_r,
        odom_i=oi,
        odom_j=oj,
        odom_t=ot,
        odom_q=oq,
        odom_mask=oqm,
    )
    if gather_tables:
        tables = build_gather_tables(op, ol, omask, Pc, Lc)
        arrays.update(zip(("pose_obs", "pose_obs_mask", "lm_obs", "lm_obs_mask"), tables))
    return arrays
