"""SLAMProblem serialization to npz (port of io/serialize.py).

The same keys, shapes and dtypes as the JAX package writes and reads, so
either package's output feeds either package's BA backend.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from vision_slam_frontend_tpu_torch.types.slam_types import (
    FeatureMatch,
    OdometryFactor,
    RobotPose,
    SLAMNode,
    SLAMProblem,
    VisionFactor,
    VisionFeature,
)

FORMAT_VERSION = 1


def problem_to_arrays(problem: SLAMProblem, node_track_ids: Optional[list] = None) -> dict:
    """Flatten a SLAMProblem into a dict of numpy arrays."""
    nodes = problem.nodes
    out = {
        "format_version": np.int32(FORMAT_VERSION),
        "nodes_id": np.array([n.node_idx for n in nodes], np.int64),
        "nodes_timestamp": np.array([n.timestamp for n in nodes], np.float64),
        "nodes_loc": np.array([n.pose.loc for n in nodes], np.float32).reshape(-1, 3),
        "nodes_quat": np.array([n.pose.angle for n in nodes], np.float32).reshape(-1, 4),
    }
    feat_node, feat_idx, feat_pixel, feat_p3d = [], [], [], []
    feat_pixel_right, feat_has_right = [], []
    for n in nodes:
        for f in n.features:
            feat_node.append(n.node_idx)
            feat_idx.append(f.feature_idx)
            feat_pixel.append(f.pixel)
            feat_p3d.append(f.point3d)
            pr = f.pixel_right
            feat_pixel_right.append(pr if pr is not None else np.zeros(2))
            feat_has_right.append(pr is not None)
    out["feat_node"] = np.array(feat_node, np.int64)
    out["feat_idx"] = np.array(feat_idx, np.int64)
    out["feat_pixel"] = np.array(feat_pixel, np.float32).reshape(-1, 2)
    out["feat_point3d"] = np.array(feat_p3d, np.float32).reshape(-1, 3)
    out["feat_pixel_right"] = np.array(feat_pixel_right, np.float32).reshape(-1, 2)
    out["feat_has_right"] = np.array(feat_has_right, bool)
    if node_track_ids is not None:
        out["feat_track"] = np.concatenate(
            [np.asarray(t, np.int64) for t in node_track_ids]
        ) if node_track_ids else np.zeros(0, np.int64)

    vfs = problem.vision_factors
    out["vf_pose_initial"] = np.array([v.pose_idx_initial for v in vfs], np.int64)
    out["vf_pose_current"] = np.array([v.pose_idx_current for v in vfs], np.int64)
    m_factor, m_init, m_curr = [], [], []
    for i, v in enumerate(vfs):
        for m in v.feature_matches:
            m_factor.append(i)
            m_init.append(m.feature_idx_initial)
            m_curr.append(m.feature_idx_current)
    out["vfm_factor"] = np.array(m_factor, np.int64)
    out["vfm_initial"] = np.array(m_init, np.int64)
    out["vfm_current"] = np.array(m_curr, np.int64)

    ofs = problem.odometry_factors
    out["of_pose_i"] = np.array([o.pose_i for o in ofs], np.int64)
    out["of_pose_j"] = np.array([o.pose_j for o in ofs], np.int64)
    out["of_translation"] = np.array([o.translation for o in ofs], np.float32).reshape(-1, 3)
    out["of_rotation"] = np.array([o.rotation for o in ofs], np.float32).reshape(-1, 4)
    return out


def arrays_to_problem(data: dict) -> SLAMProblem:
    """Inverse of problem_to_arrays."""
    nodes = []
    feat_node = np.asarray(data["feat_node"])
    has_r = data.get("feat_has_right")
    px_r = data.get("feat_pixel_right")
    for k, nid in enumerate(np.asarray(data["nodes_id"])):
        sel = np.nonzero(feat_node == nid)[0]
        feats = [
            VisionFeature(
                int(data["feat_idx"][i]),
                np.asarray(data["feat_pixel"][i]),
                np.asarray(data["feat_point3d"][i]),
                pixel_right=np.asarray(px_r[i]) if has_r is not None and bool(has_r[i]) else None,
            )
            for i in sel
        ]
        nodes.append(
            SLAMNode(
                node_idx=int(nid),
                timestamp=float(data["nodes_timestamp"][k]),
                pose=RobotPose(loc=np.asarray(data["nodes_loc"][k]), angle=np.asarray(data["nodes_quat"][k])),
                features=feats,
            )
        )
    vfs = []
    vfm_factor = np.asarray(data["vfm_factor"])
    for i in range(len(np.asarray(data["vf_pose_initial"]))):
        sel = np.nonzero(vfm_factor == i)[0]
        vfs.append(
            VisionFactor(
                pose_idx_initial=int(data["vf_pose_initial"][i]),
                pose_idx_current=int(data["vf_pose_current"][i]),
                feature_matches=[
                    FeatureMatch(int(data["vfm_initial"][j]), int(data["vfm_current"][j])) for j in sel
                ],
            )
        )
    ofs = [
        OdometryFactor(
            pose_i=int(data["of_pose_i"][i]),
            pose_j=int(data["of_pose_j"][i]),
            translation=np.asarray(data["of_translation"][i]),
            rotation=np.asarray(data["of_rotation"][i]),
        )
        for i in range(len(np.asarray(data["of_pose_i"])))
    ]
    return SLAMProblem(nodes=nodes, vision_factors=vfs, odometry_factors=ofs)


def save_problem(
    path: str, problem: SLAMProblem, config=None, node_track_ids: Optional[list] = None
) -> None:
    """Write the npz artifact; includes calibration when config is given."""
    data = problem_to_arrays(problem, node_track_ids)
    if config is not None:
        data["calib_K_left"] = np.asarray(config.K_left)
        data["calib_K_right"] = np.asarray(config.K_right)
        data["calib_P_left"] = np.asarray(config.P_left)
        data["calib_P_right"] = np.asarray(config.P_right)
        data["calib_left_cam_to_robot"] = np.asarray(config.left_cam_to_robot)
        il = config.intrinsics_left
        ir = config.intrinsics_right
        data["calib_dist_left"] = np.array([il.k1, il.k2, il.p1, il.p2, il.k3], np.float32)
        data["calib_dist_right"] = np.array([ir.k1, ir.k2, ir.p1, ir.p2, ir.k3], np.float32)
        data["calib_right_extrinsic"] = np.asarray(config.calib["right_extrinsic"], np.float32)
    np.savez_compressed(path, **data)


def load_problem(path: str) -> SLAMProblem:
    with np.load(path) as data:
        return arrays_to_problem(dict(data))
