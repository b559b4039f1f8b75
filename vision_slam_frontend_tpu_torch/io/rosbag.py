"""Pure-Python ROS1 bag (v2.0) reader and writer (port of io/rosbag.py).

A copy of the JAX package's module, so the port reads and writes bags where
the JAX package is not installed; the bytes it writes equal the JAX
package's for the same messages. The format
(http://wiki.ros.org/Bags/Format/2.0):

  file := "#ROSBAG V2.0\\n" record*
  record := header_len(u32) header data_len(u32) data
  header := (field_len(u32) name "=" value)*

Reading: stream top-level records; decompress chunks (none/bz2; lz4 when the
lz4 module exists); collect connection records; yield message records in file
order. Writing: chunked uncompressed records with index and chunk-info
records and a back-filled bag-header record, so standard ROS tooling accepts
the output. Message (de)serializers cover the types the frontend consumes
(sensor_msgs/CompressedImage, nav_msgs/Odometry); io/ros_msgs.py has the
ones it emits.
"""

from __future__ import annotations

import bz2
import struct
from typing import Callable, Dict, Iterator, List, Optional, Tuple

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HEADER = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONNECTION = 0x07


# ---------------------------------------------------------------------------
# Low-level record plumbing
# ---------------------------------------------------------------------------


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        field = buf[off : off + flen]
        off += flen
        name, _, value = field.partition(b"=")
        fields[name] = value
    return fields


def _encode_header(fields: Dict[bytes, bytes]) -> bytes:
    out = b""
    for name, value in fields.items():
        field = name + b"=" + value
        out += struct.pack("<I", len(field)) + field
    return out


def _iter_records(buf: bytes, off: int = 0) -> Iterator[Tuple[Dict[bytes, bytes], bytes, int]]:
    """Yield (header, data, next_offset) records from a buffer."""
    n = len(buf)
    while off + 4 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        header = _parse_header(buf[off : off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        off += 4
        data = buf[off : off + dlen]
        off += dlen
        yield header, data, off


def _decompress(data: bytes, compression: bytes) -> bytes:
    if compression in (b"none", b""):
        return data
    if compression == b"bz2":
        return bz2.decompress(data)
    if compression == b"lz4":
        try:
            import lz4.frame  # type: ignore
        except ImportError as e:
            raise RuntimeError("bag uses lz4 compression but the lz4 module is unavailable") from e
        return lz4.frame.decompress(data)
    raise ValueError(f"unknown bag compression {compression!r}")


# ---------------------------------------------------------------------------
# Message deserializers (wire format: little-endian ROS1 serialization)
# ---------------------------------------------------------------------------


class _Cursor:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def f64(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def f64s(self, n: int) -> Tuple[float, ...]:
        v = struct.unpack_from(f"<{n}d", self.buf, self.off)
        self.off += 8 * n
        return v

    def string(self) -> bytes:
        n = self.u32()
        s = self.buf[self.off : self.off + n]
        self.off += n
        return s

    def bytes_(self) -> bytes:
        n = self.u32()
        b = self.buf[self.off : self.off + n]
        self.off += n
        return b

    def ros_header(self) -> Tuple[int, int]:
        """std_msgs/Header -> (seq, stamp_ns)."""
        seq = self.u32()
        sec = self.u32()
        nsec = self.u32()
        self.string()  # frame_id
        return seq, sec * 1_000_000_000 + nsec


def _parse_compressed_image(data: bytes) -> dict:
    c = _Cursor(data)
    seq, stamp_ns = c.ros_header()
    fmt = c.string().decode(errors="replace")
    payload = c.bytes_()
    return {"seq": seq, "stamp_ns": stamp_ns, "format": fmt, "data": payload}


def _parse_odometry(data: bytes) -> dict:
    import numpy as np

    c = _Cursor(data)
    seq, stamp_ns = c.ros_header()
    c.string()  # child_frame_id
    px, py, pz = c.f64s(3)
    qx, qy, qz, qw = c.f64s(4)
    c.f64s(36)  # pose covariance
    tvx, tvy, tvz = c.f64s(3)
    avx, avy, avz = c.f64s(3)
    c.f64s(36)  # twist covariance
    return {
        "seq": seq,
        "stamp_ns": stamp_ns,
        "position": np.array([px, py, pz]),
        "orientation_wxyz": np.array([qw, qx, qy, qz]),
        "linear_velocity": np.array([tvx, tvy, tvz]),
        "angular_velocity": np.array([avx, avy, avz]),
    }


DESERIALIZERS: Dict[str, Callable[[bytes], dict]] = {
    "sensor_msgs/CompressedImage": _parse_compressed_image,
    "nav_msgs/Odometry": _parse_odometry,
}


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


def read_messages(
    path: str, topics: Optional[List[str]] = None, raw: bool = False
) -> Iterator[Tuple[str, int, dict]]:
    """Stream (topic, time_ns, message) from a bag in file order.

    Unknown message types (or raw=True) yield {"raw": bytes, "type": str}.
    """
    topic_set = set(topics) if topics else None
    connections: Dict[int, Tuple[str, str]] = {}  # conn id -> (topic, type)

    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"{path}: not a ROS bag v2.0 file (magic {magic!r})")
        buf = f.read()

    def handle_connection(header: Dict[bytes, bytes], data: bytes) -> None:
        conn = struct.unpack("<I", header[b"conn"])[0]
        conn_fields = _parse_header(data)
        topic = (conn_fields.get(b"topic") or header.get(b"topic", b"")).decode()
        mtype = conn_fields.get(b"type", b"").decode()
        connections[conn] = (topic, mtype)

    def emit(header: Dict[bytes, bytes], data: bytes):
        conn = struct.unpack("<I", header[b"conn"])[0]
        (t_ns,) = struct.unpack("<Q", header[b"time"])
        topic, mtype = connections.get(conn, ("", ""))
        if topic_set is not None and topic not in topic_set:
            return None
        parser = None if raw else DESERIALIZERS.get(mtype)
        if parser is None:
            return topic, t_ns, {"raw": data, "type": mtype}
        return topic, t_ns, parser(data)

    for header, data, _ in _iter_records(buf):
        op = header.get(b"op", b"\x00")[0]
        if op == OP_CONNECTION:
            handle_connection(header, data)
        elif op == OP_CHUNK:
            chunk = _decompress(data, header.get(b"compression", b"none"))
            for ch, cd, _ in _iter_records(chunk):
                cop = ch.get(b"op", b"\x00")[0]
                if cop == OP_CONNECTION:
                    handle_connection(ch, cd)
                elif cop == OP_MSG:
                    out = emit(ch, cd)
                    if out is not None:
                        yield out
        elif op == OP_MSG:
            out = emit(header, data)
            if out is not None:
                yield out
        # OP_INDEX / OP_CHUNK_INFO / OP_BAG_HEADER: streaming reader skips.


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _time_fields(t_ns: int) -> bytes:
    return struct.pack("<Q", t_ns)


class BagWriter:
    """Minimal-but-valid chunked ROS1 bag writer (uncompressed chunks).

    Writes connection + message records into chunks, index records after each
    chunk, chunk-info records at the end, and back-fills the bag-header
    record — the structure standard ROS tools expect.
    """

    def __init__(self, path: str, chunk_threshold: int = 768 * 1024):
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        # Placeholder bag header record (op=3), padded to 4096 total.
        self._bag_header_pos = self._f.tell()
        self._write_bag_header(0, 0, 0)
        self._chunk_threshold = chunk_threshold
        self._connections: Dict[Tuple[str, str], int] = {}
        self._conn_headers: Dict[int, Tuple[Dict[bytes, bytes], bytes]] = {}
        self._chunk_buf = b""
        self._chunk_index: Dict[int, List[Tuple[int, int]]] = {}  # conn -> [(t_ns, offset)]
        self._chunk_start_time: Optional[int] = None
        self._chunk_end_time: int = 0
        self._chunk_infos: List[tuple] = []
        self._closed = False

    def _write_bag_header(self, index_pos: int, conn_count: int, chunk_count: int) -> None:
        header = _encode_header(
            {
                b"op": bytes([OP_BAG_HEADER]),
                b"index_pos": struct.pack("<Q", index_pos),
                b"conn_count": struct.pack("<I", conn_count),
                b"chunk_count": struct.pack("<I", chunk_count),
            }
        )
        total = 4096
        pad_len = total - 8 - len(header)
        data = b" " * pad_len
        self._f.write(struct.pack("<I", len(header)) + header)
        self._f.write(struct.pack("<I", len(data)) + data)

    @staticmethod
    def _record(header: Dict[bytes, bytes], data: bytes) -> bytes:
        h = _encode_header(header)
        return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data

    def get_connection(
        self, topic: str, msg_type: str, md5sum: str, definition: str
    ) -> int:
        key = (topic, msg_type)
        if key in self._connections:
            return self._connections[key]
        conn = len(self._connections)
        self._connections[key] = conn
        header = {
            b"op": bytes([OP_CONNECTION]),
            b"conn": struct.pack("<I", conn),
            b"topic": topic.encode(),
        }
        conn_data = _encode_header(
            {
                b"topic": topic.encode(),
                b"type": msg_type.encode(),
                b"md5sum": md5sum.encode(),
                b"message_definition": definition.encode(),
            }
        )
        self._conn_headers[conn] = (header, conn_data)
        self._chunk_buf += self._record(header, conn_data)
        return conn

    def write(self, conn: int, t_ns: int, serialized: bytes) -> None:
        if self._closed:
            raise ValueError("bag already closed")
        offset = len(self._chunk_buf)
        header = {
            b"op": bytes([OP_MSG]),
            b"conn": struct.pack("<I", conn),
            b"time": _time_fields(t_ns),
        }
        self._chunk_buf += self._record(header, serialized)
        self._chunk_index.setdefault(conn, []).append((t_ns, offset))
        if self._chunk_start_time is None or t_ns < self._chunk_start_time:
            self._chunk_start_time = t_ns
        self._chunk_end_time = max(self._chunk_end_time, t_ns)
        if len(self._chunk_buf) >= self._chunk_threshold:
            self._flush_chunk()

    def _flush_chunk(self) -> None:
        if not self._chunk_buf:
            return
        chunk_pos = self._f.tell()
        data = self._chunk_buf
        header = {
            b"op": bytes([OP_CHUNK]),
            b"compression": b"none",
            b"size": struct.pack("<I", len(data)),
        }
        self._f.write(self._record(header, data))
        # Index records (version 1) for each connection in this chunk.
        for conn, entries in self._chunk_index.items():
            idx_header = {
                b"op": bytes([OP_INDEX]),
                b"ver": struct.pack("<I", 1),
                b"conn": struct.pack("<I", conn),
                b"count": struct.pack("<I", len(entries)),
            }
            idx_data = b"".join(
                struct.pack("<Q", t) + struct.pack("<I", off) for t, off in entries
            )
            self._f.write(self._record(idx_header, idx_data))
        start = self._chunk_start_time or 0
        end = self._chunk_end_time
        counts = {conn: len(v) for conn, v in self._chunk_index.items()}
        self._chunk_infos.append((chunk_pos, start, end, counts))
        self._chunk_buf = b""
        self._chunk_index = {}
        self._chunk_start_time = None
        self._chunk_end_time = 0

    def close(self) -> None:
        if self._closed:
            return
        self._flush_chunk()
        index_pos = self._f.tell()
        # Connection records (again, at the index section).
        for conn in sorted(self._conn_headers):
            header, conn_data = self._conn_headers[conn]
            self._f.write(self._record(header, conn_data))
        # Chunk info records (version 1).
        for chunk_pos, start, end, counts in self._chunk_infos:
            info_header = {
                b"op": bytes([OP_CHUNK_INFO]),
                b"ver": struct.pack("<I", 1),
                b"chunk_pos": struct.pack("<Q", chunk_pos),
                b"start_time": struct.pack("<Q", start),
                b"end_time": struct.pack("<Q", end),
                b"count": struct.pack("<I", len(counts)),
            }
            info_data = b"".join(
                struct.pack("<I", conn) + struct.pack("<I", n)
                for conn, n in sorted(counts.items())
            )
            self._f.write(self._record(info_header, info_data))
        # Back-fill the bag header.
        end_pos = self._f.tell()
        self._f.seek(self._bag_header_pos)
        self._write_bag_header(index_pos, len(self._conn_headers), len(self._chunk_infos))
        self._f.seek(end_pos)
        self._f.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Serializers for the input types (used by tests and bag_extract round-trips)
# ---------------------------------------------------------------------------


def _ser_string(s: str | bytes) -> bytes:
    b = s.encode() if isinstance(s, str) else s
    return struct.pack("<I", len(b)) + b


def _ser_ros_header(seq: int, stamp_ns: int, frame_id: str = "") -> bytes:
    sec, nsec = divmod(stamp_ns, 1_000_000_000)
    return struct.pack("<III", seq, sec, nsec) + _ser_string(frame_id)


def serialize_compressed_image(seq: int, stamp_ns: int, fmt: str, data: bytes) -> bytes:
    return (
        _ser_ros_header(seq, stamp_ns)
        + _ser_string(fmt)
        + struct.pack("<I", len(data))
        + data
    )


def serialize_odometry(
    seq: int,
    stamp_ns: int,
    position,
    orientation_wxyz,
    frame_id: str = "odom",
) -> bytes:
    w, x, y, z = [float(v) for v in orientation_wxyz]
    px, py, pz = [float(v) for v in position]
    zeros36 = struct.pack("<36d", *([0.0] * 36))
    zeros3 = struct.pack("<3d", 0.0, 0.0, 0.0)
    return (
        _ser_ros_header(seq, stamp_ns, frame_id)
        + _ser_string("base_link")
        + struct.pack("<3d", px, py, pz)
        + struct.pack("<4d", x, y, z, w)
        + zeros36
        + zeros3
        + zeros3
        + zeros36
    )
