"""ctypes bindings for the native host library (port of io/native_loader.py).

The library is the JAX package's `native/vsf_native.cpp`: a threaded
libjpeg decoder and a ROS1 bag record scanner with a plain C interface. The
port never loads the JAX package's prebuilt `native/vsf_native.so`: it
builds its own from the source at first use, with g++, into `build/native/`
at the root of the checkout, named by a hash of the source and the flags.
Several processes may build at once (test workers): each writes a file
tagged with its pid and renames it into place.

Where g++ or libjpeg's `jpeglib.h` is missing, the native route is
unavailable (`native_available()` is False, `unavailable_reason()` says
why) and callers take the Python paths (io/image.py, io/rosbag.py), as the
JAX package does without its library. Where the header exists and the build
fails, that is an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "vsf_native.cpp"
BUILD_DIR = ROOT / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")
LIBS = ("-ljpeg", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_unavailable: Optional[str] = None  # why the native route is unavailable, once known
build_seconds: Optional[float] = None  # wall time of the build this process ran


class _BagConnection(ctypes.Structure):
    _fields_ = [
        ("conn", ctypes.c_int32),
        ("topic", ctypes.c_char * 256),
        ("type", ctypes.c_char * 128),
    ]


class _BagRecord(ctypes.Structure):
    _fields_ = [
        ("conn", ctypes.c_int32),
        ("time_ns", ctypes.c_int64),
        ("offset", ctypes.c_int64),
        ("size", ctypes.c_int64),
    ]


def _cxx() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvsf_native_{h.hexdigest()[:16]}.so"


def _missing_prerequisite(cxx: Optional[str]) -> Optional[str]:
    """Why the library cannot be built here (no compiler, no jpeglib.h), or
    None."""
    if cxx is None:
        return f"no C++ compiler ({os.environ.get('CXX', 'g++')}) on PATH"
    if not SOURCE.is_file():
        return f"{SOURCE} is missing"
    probe = subprocess.run(
        [cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
        input="#include <cstddef>\n#include <cstdio>\n#include <jpeglib.h>\n",
        capture_output=True, text=True,
    )
    if probe.returncode != 0:
        return "libjpeg's jpeglib.h not found"
    return None


def _build(cxx: str, out: Path) -> None:
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native library failed:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.vsf_decode_jpeg_gray.restype = ctypes.c_int
    lib.vsf_decode_jpeg_gray.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.vsf_decode_jpeg_batch.restype = ctypes.c_int
    lib.vsf_decode_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.vsf_bag_open.restype = ctypes.c_void_p
    lib.vsf_bag_open.argtypes = [ctypes.c_char_p]
    lib.vsf_bag_num_records.restype = ctypes.c_int32
    lib.vsf_bag_num_records.argtypes = [ctypes.c_void_p]
    lib.vsf_bag_num_connections.restype = ctypes.c_int32
    lib.vsf_bag_num_connections.argtypes = [ctypes.c_void_p]
    lib.vsf_bag_get_connections.restype = None
    lib.vsf_bag_get_connections.argtypes = [ctypes.c_void_p, ctypes.POINTER(_BagConnection)]
    lib.vsf_bag_get_records.restype = None
    lib.vsf_bag_get_records.argtypes = [ctypes.c_void_p, ctypes.POINTER(_BagRecord)]
    lib.vsf_bag_read.restype = ctypes.c_int
    lib.vsf_bag_read.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
    lib.vsf_bag_close.restype = None
    lib.vsf_bag_close.argtypes = [ctypes.c_void_p]
    return lib


def load_native() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if this source hash has none; None
    where the native route is unavailable (see unavailable_reason)."""
    global _lib, _unavailable
    with _lock:
        if _lib is None and _unavailable is None:
            path = library_path()
            lib = None
            if path.is_file():
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError:  # built on another machine (a copied checkout): build anew
                    lib = None
            if lib is None:
                cxx = _cxx()
                _unavailable = _missing_prerequisite(cxx)
                if _unavailable is not None:
                    return None
                _build(cxx, path)
                lib = ctypes.CDLL(str(path))
            _lib = _bind(lib)
        return _lib


def native_available() -> bool:
    return load_native() is not None


def unavailable_reason() -> Optional[str]:
    """Why the native route is unavailable (None where it is available)."""
    load_native()
    return _unavailable


def decode_jpeg_gray(data: bytes) -> Optional[np.ndarray]:
    """Decode one JPEG to a grayscale uint8 array; None if the library is
    unavailable or the buffer is not a decodable JPEG."""
    lib = load_native()
    if lib is None:
        return None
    w = ctypes.c_int32()
    h = ctypes.c_int32()
    rc = lib.vsf_decode_jpeg_gray(data, len(data), None, 0, ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    out = np.empty((h.value, w.value), np.uint8)
    rc = lib.vsf_decode_jpeg_gray(
        data, len(data), out.ctypes.data_as(ctypes.c_void_p), out.size,
        ctypes.byref(w), ctypes.byref(h),
    )
    return out if rc == 0 else None


def decode_jpeg_batch(
    buffers: List[bytes], width: int, height: int, num_threads: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode N same-sized JPEGs concurrently -> ((N, H, W) uint8, status (N,));
    a buffer that fails to decode is zero-filled with a non-zero status."""
    lib = load_native()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_unavailable}")
    n = len(buffers)
    out = np.zeros((n, height, width), np.uint8)
    status = np.zeros(n, np.int32)
    datas = (ctypes.c_char_p * n)(*buffers)
    lens = (ctypes.c_int64 * n)(*[len(b) for b in buffers])
    lib.vsf_decode_jpeg_batch(
        datas, lens, n, out.ctypes.data_as(ctypes.c_void_p), width, height,
        num_threads, status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out, status


class NativeBagReader:
    """A bag indexed by the C++ scanner: every record's (connection, time,
    offset, size) up front. The scanner indexes uncompressed chunks only;
    io/rosbag.py reads compressed ones."""

    def __init__(self, path: str):
        lib = load_native()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_unavailable}")
        self._lib = lib
        self._handle = lib.vsf_bag_open(path.encode())
        if not self._handle:
            raise ValueError(f"{path}: not a readable ROS bag v2.0 file")
        nconn = lib.vsf_bag_num_connections(self._handle)
        conns = (_BagConnection * nconn)()
        lib.vsf_bag_get_connections(self._handle, conns)
        self.connections = {c.conn: (c.topic.decode(), c.type.decode()) for c in conns}
        nrec = lib.vsf_bag_num_records(self._handle)
        recs = (_BagRecord * nrec)()
        lib.vsf_bag_get_records(self._handle, recs)
        self._records = [(r.conn, r.time_ns, r.offset, r.size) for r in recs]

    def __len__(self) -> int:
        return len(self._records)

    def read_messages(self, topics: Optional[List[str]] = None) -> Iterator[Tuple[str, int, bytes]]:
        """Yield (topic, t_ns, raw serialized body) in file order."""
        topic_set = set(topics) if topics else None
        for conn, t_ns, offset, size in self._records:
            topic, _ = self.connections.get(conn, ("", ""))
            if topic_set is not None and topic not in topic_set:
                continue
            buf = np.empty(size, np.uint8)
            if self._lib.vsf_bag_read(self._handle, offset, size, buf.ctypes.data_as(ctypes.c_void_p)) != 0:
                continue
            yield topic, t_ns, buf.tobytes()

    def close(self) -> None:
        if self._handle:
            self._lib.vsf_bag_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
