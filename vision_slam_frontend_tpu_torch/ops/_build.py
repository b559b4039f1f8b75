"""Build the port's CUDA kernels at first use and load them with ctypes.

The sources in `csrc/` compile with nvcc for Hopper (sm_90a), one nvcc
process per source, all started together, and link into one shared library
with a plain C interface. It lands in `build/torch_kernels/`
at the root of the checkout, named by a hash of the sources and flags, so an
edited `.cu` file builds a new library. Nothing is built at import time: the
first call of a kernel wrapper on a CUDA tensor builds and loads it.
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

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("fast_nms.cu", "extract_patches.cu", "hamming_top2.cu", "patch_windows.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: (argtypes, restype)
    "vsf_fast_scores_nms": ((_P, _I, _I, _I, _P, _P, _P), _I),
    "vsf_extract_patches": ((_P, _I, _I, _I, _I, _P, _I, _I, _P, _P), _I),
    "vsf_hamming_top2": ((_P, _P, _P, _I, _I, _I, _P, _P, _P, _P), _I),
    "vsf_patch_windows": ((_P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P), _I),
    "vsf_error_string": ((_I,), ctypes.c_char_p),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the build this process ran
ptxas_log: dict[str, str] = {}  # source -> what `-Xptxas -v` printed for it, from that build


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {candidate} and on PATH): the CUDA "
            "kernels are built from csrc/ at first use and need the CUDA toolkit"
        )
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libvsf_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _check(proc: subprocess.Popen, cmd: list[str]) -> str:
    output = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{output}")
    return output


def kernel_resources() -> dict[str, str]:
    """Per kernel function, what ptxas reported for it in this process's
    build (registers, shared memory, spills), one line each."""
    out = {}
    for log in ptxas_log.values():
        name = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif name is not None and ("Used" in line or "spill" in line):
                fact = line.split("info    :", 1)[-1].strip()
                out[name] = f"{out[name]}; {fact}" if name in out else fact
    return out


def _build(out: Path) -> None:
    """Compile every source at once (one nvcc each), then link."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    objects = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    jobs = []
    for src, obj in zip(SOURCES, objects):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)]
        jobs.append((_run(cmd), cmd))
    try:
        for src, (proc, cmd) in zip(SOURCES, jobs):
            ptxas_log[src] = _check(proc, cmd)
    finally:
        for proc, _ in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objects)]
    _check(_run(cmd), cmd)
    os.replace(tmp, out)
    for obj in objects:
        obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has none."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = restype
            _lib = lib
        return _lib
