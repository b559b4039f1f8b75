"""Multi-session map merging (port of backend/merge.py): several SLAMProblems
-> one joint BA problem.

Sessions mapped independently are aligned by an initial SE(3) guess per
session, their landmark clouds are associated by 3D proximity (voxel-hash
nearest neighbour), matched tracks are unioned, and the merged problem is
jointly bundle-adjusted (optionally with the anchor session's poses frozen).
Numpy on the host, as in the JAX package; merge_sessions uploads the joint
BA problem once, to the device the caller names.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import numpy as np

from vision_slam_frontend_tpu_torch.backend.tracks import _UnionFind, build_ba_arrays, build_gather_tables
from vision_slam_frontend_tpu_torch.types.slam_types import (
    BAProblem,
    OdometryFactor,
    SLAMNode,
    SLAMProblem,
    VisionFactor,
)
from vision_slam_frontend_tpu_torch.utils import np_geom
from vision_slam_frontend_tpu_torch.utils.device import resolve_device


def transform_problem(problem: SLAMProblem, t: np.ndarray, q: np.ndarray) -> SLAMProblem:
    """Apply a world-frame SE(3) transform to all node poses (deep copy).

    Feature point3d stay untouched: they live in each node's camera frame.
    """
    out = copy.deepcopy(problem)
    t = np.asarray(t, np.float64)
    q = np_geom.quat_normalize(np.asarray(q, np.float64))
    for node in out.nodes:
        node.pose.loc = (np_geom.quat_rotate(q, np.asarray(node.pose.loc, np.float64)) + t).astype(np.float32)
        node.pose.angle = np_geom.quat_multiply(q, np.asarray(node.pose.angle, np.float64)).astype(np.float32)
    return out


def merge_slam_problems(
    problems: Sequence[SLAMProblem],
    transforms: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
) -> Tuple[SLAMProblem, np.ndarray]:
    """Concatenate sessions into one problem with re-indexed poses.

    Args:
      problems: per-session SLAMProblems.
      transforms: per-session (t, q_wxyz) mapping the session world frame
        into the common frame (defaults to identity).

    Returns (merged problem, session_of_pose (P,) int array).
    """
    merged = SLAMProblem()
    session_of_pose = []
    offset = 0
    for s, problem in enumerate(problems):
        if transforms is not None:
            t, q = transforms[s]
            problem = transform_problem(problem, t, q)
        else:
            problem = copy.deepcopy(problem)
        for node in problem.nodes:
            merged.nodes.append(SLAMNode(node.node_idx + offset, node.timestamp, node.pose, node.features))
            session_of_pose.append(s)
        for vf in problem.vision_factors:
            merged.vision_factors.append(
                VisionFactor(vf.pose_idx_initial + offset, vf.pose_idx_current + offset, vf.feature_matches)
            )
        for of in problem.odometry_factors:
            merged.odometry_factors.append(
                OdometryFactor(of.pose_i + offset, of.pose_j + offset, of.translation, of.rotation)
            )
        offset += len(problem.nodes)
    return merged, np.asarray(session_of_pose)


def associate_landmarks(arrays: dict, session_of_pose: np.ndarray, radius: float = 0.3):
    """Merge cross-session landmarks whose initial 3D positions agree.

    Voxel-hash nearest neighbour on landmark positions: landmarks from
    DIFFERENT sessions within `radius` get unioned (observations pooled),
    which is what ties the sessions' maps together in the joint BA. Takes
    and returns BA arrays in numpy (tracks.build_ba_arrays'; its gather
    tables, if any, are not read): remapped obs_landmark, compacted
    landmarks at a 128-multiple capacity and rebuilt gather tables, with the
    number of merged pairs.
    """
    lm = arrays["landmarks"]
    lm_mask = arrays["landmark_mask"]
    obs_pose = arrays["obs_pose"]
    obs_lm = arrays["obs_landmark"]
    obs_mask = arrays["obs_mask"]

    # Dominant session per landmark (from its observations).
    L = lm.shape[0]
    lm_session = np.full(L, -1)
    for n in np.nonzero(obs_mask)[0]:
        if lm_session[obs_lm[n]] < 0:
            lm_session[obs_lm[n]] = session_of_pose[obs_pose[n]]

    # Voxel hash for proximity association.
    cell = radius
    grid: dict = {}
    valid_ids = np.nonzero(lm_mask)[0]
    for j in valid_ids:
        key = tuple((lm[j] // cell).astype(np.int64))
        grid.setdefault(key, []).append(j)

    uf = _UnionFind()
    merged_pairs = 0
    for j in valid_ids:
        base = (lm[j] // cell).astype(np.int64)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for k in grid.get((base[0] + dx, base[1] + dy, base[2] + dz), ()):
                        if k <= j or lm_session[k] == lm_session[j]:
                            continue
                        if np.linalg.norm(lm[j] - lm[k]) <= radius:
                            if uf.find(j) != uf.find(k):
                                uf.union(j, k)
                                merged_pairs += 1

    # Remap to compact ids.
    root_of = np.arange(L)
    for j in valid_ids:
        root_of[j] = uf.find(j)
    new_id = {}
    positions = []
    for j in valid_ids:
        r = root_of[j]
        if r not in new_id:
            new_id[r] = len(new_id)
            positions.append(lm[r])
    L_new = len(new_id)
    Lc = max(128, ((L_new + 127) // 128) * 128)
    new_lm = np.zeros((Lc, 3), np.float32)
    new_lm_mask = np.zeros(Lc, bool)
    if L_new:
        new_lm[:L_new] = np.stack(positions)
        new_lm_mask[:L_new] = True
    new_obs_lm = obs_lm.copy()
    for n in np.nonzero(obs_mask)[0]:
        new_obs_lm[n] = new_id[root_of[obs_lm[n]]]

    pose_obs, pose_obs_mask, lm_obs, lm_obs_mask = build_gather_tables(
        obs_pose, new_obs_lm, obs_mask, arrays["poses_t"].shape[0], Lc
    )
    out = dict(arrays, landmarks=new_lm, landmark_mask=new_lm_mask, obs_landmark=new_obs_lm.astype(np.int32),
               pose_obs=pose_obs, pose_obs_mask=pose_obs_mask, lm_obs=lm_obs, lm_obs_mask=lm_obs_mask)
    return out, merged_pairs


def merge_sessions(
    problems: Sequence[SLAMProblem],
    transforms: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
    left_cam_to_robot: Optional[np.ndarray] = None,
    assoc_radius: float = 0.3,
    freeze_anchor: bool = True,
    device="cuda",
):
    """Full merge pipeline: concat + align -> tracks -> associate -> BAProblem.

    Returns (BAProblem on `device`, ready for optimize(); info dict). With
    `freeze_anchor`, session 0's poses are frozen so the other sessions are
    pulled onto its frame.
    """
    device = resolve_device(device)
    merged, session_of_pose = merge_slam_problems(problems, transforms)
    arrays = build_ba_arrays(merged, left_cam_to_robot=left_cam_to_robot, gather_tables=False)
    arrays, merged_pairs = associate_landmarks(arrays, session_of_pose, assoc_radius)
    if freeze_anchor:
        arrays["pose_fixed"] = np.arange(arrays["poses_t"].shape[0]) < int(np.sum(session_of_pose == 0))
    ba = BAProblem.from_numpy(arrays, device=device)
    info = {
        "num_sessions": len(problems),
        "num_poses": len(merged.nodes),
        "merged_landmark_pairs": merged_pairs,
        "num_landmarks": int(arrays["landmark_mask"].sum()),
        "session_of_pose": session_of_pose,
    }
    return ba, info
