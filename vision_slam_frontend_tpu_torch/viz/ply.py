"""PLY export of the pose graph + triangulated landmark cloud (port of
viz/ply.py).

A headless stand-in for the reference's live RViz markers, with the same
content: red pose nodes, green odometry edges, blue vision-factor edges,
white landmark points with the reference's z > 0.1 / 0.5 < ||p|| < 20
display filter, written as colored binary PLY that point-cloud viewers open.
The bytes equal the JAX package's for the same problem.
"""

from __future__ import annotations

import numpy as np

from vision_slam_frontend_tpu_torch.types.slam_types import SLAMProblem
from vision_slam_frontend_tpu_torch.utils import np_geom

# Marker colors, the reference's RViz scheme.
COLOR_NODE = (255, 0, 0)
COLOR_ODOM_EDGE = (0, 255, 0)
COLOR_VISION_EDGE = (0, 0, 255)
COLOR_LANDMARK = (255, 255, 255)


def _write_ply(path: str, points: np.ndarray, colors: np.ndarray, edges: np.ndarray | None = None) -> None:
    n = len(points)
    ne = 0 if edges is None else len(edges)
    with open(path, "wb") as f:
        header = [
            "ply",
            "format binary_little_endian 1.0",
            f"element vertex {n}",
            "property float x",
            "property float y",
            "property float z",
            "property uchar red",
            "property uchar green",
            "property uchar blue",
            f"element edge {ne}",
            "property int vertex1",
            "property int vertex2",
            "end_header",
        ]
        f.write(("\n".join(header) + "\n").encode())
        rec = np.zeros(
            n, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)]
        )
        rec["xyz"] = points.astype(np.float32)
        rec["rgb"] = colors.astype(np.uint8)
        f.write(rec.tobytes())
        if ne:
            erec = np.asarray(edges, np.int32)
            f.write(erec.astype("<i4").tobytes())


def node_landmarks_world(node, left_cam_to_robot: np.ndarray) -> np.ndarray:
    """One node's world-frame landmark points with the reference's display
    filter (z > 0.1, 0.5 < ||p|| < 20)."""
    if not node.features:
        return np.zeros((0, 3))
    R_cr = left_cam_to_robot[:3, :3]
    t_cr = left_cam_to_robot[:3, 3]
    p3d = np.array([f.point3d for f in node.features], np.float64)
    finite = np.all(np.isfinite(p3d), axis=-1)
    norm = np.linalg.norm(p3d, axis=-1)
    keep = finite & (p3d[:, 2] > 0.1) & (norm > 0.5) & (norm < 20.0)
    if not np.any(keep):
        return np.zeros((0, 3))
    p_robot = p3d[keep] @ R_cr.T + t_cr
    q = np.asarray(node.pose.angle, np.float64)
    return np.stack([np_geom.quat_rotate(q, p) for p in p_robot]) + np.asarray(
        node.pose.loc, np.float64
    )


def landmark_points_world(problem: SLAMProblem, left_cam_to_robot: np.ndarray) -> np.ndarray:
    """World-frame landmark cloud with the reference's display filter."""
    pts = [node_landmarks_world(n, left_cam_to_robot) for n in problem.nodes]
    pts = [p for p in pts if len(p)]
    return np.concatenate(pts, axis=0) if pts else np.zeros((0, 3))


def export_ply(path: str, problem: SLAMProblem, left_cam_to_robot: np.ndarray | None = None) -> dict:
    """Write pose-graph + landmark PLY. Returns counts for logging."""
    if left_cam_to_robot is None:
        left_cam_to_robot = np.eye(4)
    node_pts = np.array([n.pose.loc for n in problem.nodes], np.float64).reshape(-1, 3)
    landmarks = landmark_points_world(problem, left_cam_to_robot)

    points = [node_pts, landmarks]
    colors = [
        np.tile(COLOR_NODE, (len(node_pts), 1)),
        np.tile(COLOR_LANDMARK, (len(landmarks), 1)),
    ]
    edges = []
    id_to_row = {n.node_idx: i for i, n in enumerate(problem.nodes)}
    for f in problem.odometry_factors:
        edges.append((id_to_row[f.pose_i], id_to_row[f.pose_j]))
    for f in problem.vision_factors:
        edges.append((id_to_row[f.pose_idx_initial], id_to_row[f.pose_idx_current]))
    _write_ply(
        path,
        np.concatenate(points, axis=0),
        np.concatenate(colors, axis=0),
        np.asarray(edges, np.int32).reshape(-1, 2),
    )
    return {"nodes": len(node_pts), "landmarks": len(landmarks), "edges": len(edges)}
