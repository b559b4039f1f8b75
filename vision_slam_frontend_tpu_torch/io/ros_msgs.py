"""ROS1 message schemas and serialization of the frontend's output wire
format (port of io/ros_msgs.py).

The nine custom message types of the reference's output bag, with ROS md5sums
and full message_definition texts, so the bag is readable by ROS tooling and
by the reference's downstream backend. The bytes equal the JAX package's.

The md5 algorithm is rosmsg's: per message, the processed text keeps builtin
fields verbatim (including array specs) and replaces complex field types with
the nested type's md5 (dropping array specs); md5 over newline-joined lines.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, List, Tuple

import numpy as np

from vision_slam_frontend_tpu_torch.io.kitti import rotmat_to_quat
from vision_slam_frontend_tpu_torch.io.rosbag import BagWriter
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

PKG = "vision_slam_frontend"

_BUILTINS = {
    "bool", "int8", "uint8", "int16", "uint16", "int32", "uint32",
    "int64", "uint64", "float32", "float64", "string", "time", "duration",
    "byte", "char",
}

# (type, array_spec, name) triples per message; array_spec in {"", "[]", "[3]"}.
_SCHEMAS: Dict[str, List[Tuple[str, str, str]]] = {
    "geometry_msgs/Vector3": [("float64", "", "x"), ("float64", "", "y"), ("float64", "", "z")],
    "geometry_msgs/Point": [("float64", "", "x"), ("float64", "", "y"), ("float64", "", "z")],
    "geometry_msgs/Quaternion": [
        ("float64", "", "x"), ("float64", "", "y"), ("float64", "", "z"), ("float64", "", "w"),
    ],
    f"{PKG}/CameraExtrinsics": [
        ("float64", "[3]", "translation"), ("float64", "[3]", "rotation"),
    ],
    f"{PKG}/CameraIntrinsics": [
        ("float64", "", "fx"), ("float64", "", "fy"),
        ("float64", "", "cx"), ("float64", "", "cy"),
    ],
    f"{PKG}/FeatureMatch": [("uint64", "", "id_initial"), ("uint64", "", "id_current")],
    f"{PKG}/RobotPose": [
        ("geometry_msgs/Vector3", "", "loc"), ("geometry_msgs/Quaternion", "", "angle"),
    ],
    f"{PKG}/VisionFeature": [
        ("uint64", "", "id"),
        ("geometry_msgs/Point", "", "pixel"),
        ("geometry_msgs/Point", "", "point3d"),
    ],
    f"{PKG}/VisionFactor": [
        ("uint64", "", "pose_initial"),
        ("uint64", "", "pose_current"),
        (f"{PKG}/FeatureMatch", "[]", "feature_matches"),
    ],
    f"{PKG}/OdometryFactor": [
        ("uint64", "", "pose_i"),
        ("uint64", "", "pose_j"),
        ("geometry_msgs/Vector3", "", "translation"),
        ("geometry_msgs/Quaternion", "", "rotation"),
    ],
    f"{PKG}/SLAMNode": [
        ("uint64", "", "id"),
        ("float64", "", "timestamp"),
        (f"{PKG}/RobotPose", "", "pose"),
        (f"{PKG}/VisionFeature", "[]", "features"),
    ],
    f"{PKG}/SLAMProblem": [
        (f"{PKG}/SLAMNode", "[]", "nodes"),
        (f"{PKG}/VisionFactor", "[]", "vision_factors"),
        (f"{PKG}/OdometryFactor", "[]", "odometry_factors"),
    ],
}

_md5_cache: Dict[str, str] = {}


def msg_md5(type_name: str) -> str:
    """rosmsg-compatible md5sum of a message type."""
    if type_name in _md5_cache:
        return _md5_cache[type_name]
    lines = []
    for ftype, aspec, name in _SCHEMAS[type_name]:
        if ftype in _BUILTINS:
            lines.append(f"{ftype}{aspec} {name}")
        else:
            lines.append(f"{msg_md5(ftype)} {name}")
    digest = hashlib.md5("\n".join(lines).encode()).hexdigest()
    _md5_cache[type_name] = digest
    return digest


def _definition_text(type_name: str) -> str:
    return "\n".join(
        f"{ftype}{aspec} {name}" for ftype, aspec, name in _SCHEMAS[type_name]
    )


def _collect_deps(type_name: str, seen: List[str]) -> None:
    for ftype, _, _ in _SCHEMAS[type_name]:
        if ftype not in _BUILTINS:
            if ftype not in seen:
                seen.append(ftype)
                _collect_deps(ftype, seen)


def msg_definition(type_name: str) -> str:
    """Full gendeps-style message_definition (root + all nested types)."""
    parts = [_definition_text(type_name)]
    deps: List[str] = []
    _collect_deps(type_name, deps)
    sep = "=" * 80
    for dep in deps:
        parts.append(f"{sep}\nMSG: {dep}\n{_definition_text(dep)}")
    return "\n".join(parts) + "\n"


# ---------------------------------------------------------------------------
# Serialization of the host SLAMProblem into the reference's wire format
# ---------------------------------------------------------------------------


def _vec3(v) -> bytes:
    return struct.pack("<3d", float(v[0]), float(v[1]), float(v[2]))


def _quat_xyzw(q_wxyz) -> bytes:
    w, x, y, z = [float(c) for c in q_wxyz]
    return struct.pack("<4d", x, y, z, w)


def serialize_camera_extrinsics(translation, rotation_aa) -> bytes:
    return struct.pack("<3d", *[float(v) for v in translation]) + struct.pack(
        "<3d", *[float(v) for v in rotation_aa]
    )


def serialize_camera_intrinsics(fx, fy, cx, cy) -> bytes:
    return struct.pack("<4d", float(fx), float(fy), float(cx), float(cy))


def serialize_slam_problem(problem) -> bytes:
    """vision_slam_frontend/SLAMProblem wire bytes from the host containers
    (the reference's slam_to_ros.h: the pixel goes out as a Point with z=0)."""
    out = bytearray()
    out += struct.pack("<I", len(problem.nodes))
    for node in problem.nodes:
        out += struct.pack("<Q", node.node_idx)
        out += struct.pack("<d", float(node.timestamp))
        out += _vec3(node.pose.loc)
        out += _quat_xyzw(node.pose.angle)
        out += struct.pack("<I", len(node.features))
        for f in node.features:
            out += struct.pack("<Q", f.feature_idx)
            out += struct.pack("<3d", float(f.pixel[0]), float(f.pixel[1]), 0.0)
            out += _vec3(f.point3d)
    out += struct.pack("<I", len(problem.vision_factors))
    for vf in problem.vision_factors:
        out += struct.pack("<QQ", vf.pose_idx_initial, vf.pose_idx_current)
        out += struct.pack("<I", len(vf.feature_matches))
        for m in vf.feature_matches:
            out += struct.pack("<QQ", m.feature_idx_initial, m.feature_idx_current)
    out += struct.pack("<I", len(problem.odometry_factors))
    for of in problem.odometry_factors:
        out += struct.pack("<QQ", of.pose_i, of.pose_j)
        out += _vec3(of.translation)
        out += _quat_xyzw(of.rotation)
    return bytes(out)


def deserialize_slam_problem(data: bytes):
    """Inverse of serialize_slam_problem (for round-trip checks and for
    reading bags the reference or either package wrote)."""
    off = 0

    def u32():
        nonlocal off
        (v,) = struct.unpack_from("<I", data, off)
        off += 4
        return v

    def u64():
        nonlocal off
        (v,) = struct.unpack_from("<Q", data, off)
        off += 8
        return v

    def f64s(n):
        nonlocal off
        v = struct.unpack_from(f"<{n}d", data, off)
        off += 8 * n
        return v

    nodes = []
    for _ in range(u32()):
        nid = u64()
        ts = f64s(1)[0]
        loc = np.array(f64s(3), np.float32)
        x, y, z, w = f64s(4)
        feats = []
        for _ in range(u32()):
            fid = u64()
            px, py, _pz = f64s(3)
            p3d = np.array(f64s(3), np.float32)
            feats.append(VisionFeature(fid, np.array([px, py], np.float32), p3d))
        nodes.append(
            SLAMNode(nid, ts, RobotPose(loc, np.array([w, x, y, z], np.float32)), feats)
        )
    vfs = []
    for _ in range(u32()):
        pi = u64()
        pc = u64()
        matches = [FeatureMatch(u64(), u64()) for _ in range(u32())]
        vfs.append(VisionFactor(pi, pc, matches))
    ofs = []
    for _ in range(u32()):
        pi = u64()
        pj = u64()
        t = np.array(f64s(3), np.float32)
        x, y, z, w = f64s(4)
        ofs.append(OdometryFactor(pi, pj, t, np.array([w, x, y, z], np.float32)))
    return SLAMProblem(nodes=nodes, vision_factors=vfs, odometry_factors=ofs)


def write_output_bag(path: str, problem, config, t_ns: int = 0) -> None:
    """Write the reference-format output bag: the extrinsics, intrinsics and
    slam_problem topics."""
    ext = np.asarray(config.left_cam_to_robot, np.float64)
    R = ext[:3, :3]
    # Rotation to scaled axis-angle, like the reference's AngleAxis conversion.
    aa = np_geom.quat_to_axis_angle(rotmat_to_quat(R))
    intr = config.intrinsics_left

    with BagWriter(path) as bag:
        c_ext = bag.get_connection(
            "extrinsics", f"{PKG}/CameraExtrinsics",
            msg_md5(f"{PKG}/CameraExtrinsics"), msg_definition(f"{PKG}/CameraExtrinsics"),
        )
        bag.write(c_ext, t_ns, serialize_camera_extrinsics(ext[:3, 3], aa))
        c_intr = bag.get_connection(
            "intrinsics", f"{PKG}/CameraIntrinsics",
            msg_md5(f"{PKG}/CameraIntrinsics"), msg_definition(f"{PKG}/CameraIntrinsics"),
        )
        bag.write(
            c_intr, t_ns,
            serialize_camera_intrinsics(intr.fx, intr.fy, intr.cx, intr.cy),
        )
        c_prob = bag.get_connection(
            "slam_problem", f"{PKG}/SLAMProblem",
            msg_md5(f"{PKG}/SLAMProblem"), msg_definition(f"{PKG}/SLAMProblem"),
        )
        bag.write(c_prob, t_ns, serialize_slam_problem(problem))
