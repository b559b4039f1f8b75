"""What every cell shares: the spec files and code files found by name, the
checks that refuse a run, spans on the host clock, percentiles, and the
result line."""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import threading
import time
from contextlib import contextmanager
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vision_slam_frontend_tpu")


class Refused(Exception):
    """The run cannot give a result (no card, a missing file, a forbidden
    import): the command exits non-zero and prints no result line."""


def load_json(path: Path) -> dict:
    if not path.is_file():
        raise Refused(f"missing {path}")
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The workload `name` of BENCHMARK.json with its configuration,
    traffic and limits files, each found by name under `bench_dir`."""
    spec = load_json(bench_dir.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    return dict(
        bench_dir=bench_dir,
        spec=spec,
        cell=cell,
        config=load_json(bench_dir.parent / configs[cell["config"]]["file"]),
        traffic=load_json(bench_dir / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if name in m.get("workloads", [name])],
        per_layer=[m for m in spec["per_layer"] if name in m.get("workloads", [name])],
    )


def load_module(bench_dir: Path, folder: str, name: str):
    """The code file `bench_dir/<folder>/<name>.py` as a module: a traffic
    kind's driver (drivers/), an input of the frontend driver (inputs/), a
    per-layer reader (layer_metrics/). Later cells add such files; nothing
    lists them."""
    path = bench_dir / folder / f"{name}.py"
    if not path.is_file():
        raise Refused(f"missing {path}")
    spec = importlib.util.spec_from_file_location(f"slam_bench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark may not
    load, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def require_cuda(chips: int):
    import torch

    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is false: the benchmark measures the card only")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} CUDA devices, found {torch.cuda.device_count()}")


def cache_dirs():
    """Build and kernel caches of this run, at fixed paths inside the
    checkout (the port builds its kernels into build/torch_kernels/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        d = ROOT / "build" / "slam_bench" / sub
        d.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(d)


class Spans:
    """Host-clock spans (name, thread id, start, end) kept in memory; off
    unless `on`."""

    def __init__(self, on: bool):
        self.on = on
        self.items: list[tuple[str, int, float, float]] = []

    @contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.items.append((name, threading.get_ident(), t0, time.perf_counter()))

    def durations(self, name: str, t0: float, t1: float) -> list[float]:
        """Durations (s) of the spans `name` that started in [t0, t1)."""
        return [b - a for n, _, a, b in self.items if n == name and t0 <= a < t1]


def p95(values) -> float:
    """The nearest-rank 95th percentile."""
    v = sorted(values)
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def device_info(count: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def print_checks(checks: dict):
    """Each compared number beside its limit, as the last lines on stderr."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}, {'ok' if c['ok'] else 'FAILED'})",
              file=sys.stderr)


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {value, limit, ok}}: a number passes at or under its limit."""
    out = {}
    for name, lim in limits["limits"].items():
        v = numbers.get(name)
        ok = v is not None and math.isfinite(v) and v <= lim
        out[name] = {"value": v, "limit": lim, "ok": bool(ok)}
    return out
