"""A tiny copy of the benchmark for the CPU tests: the harness's files as
they are, and a BENCHMARK.json whose cells use small added configuration and
traffic files, so nothing of the harness is edited to run them."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from slam_bench.common import BENCH_DIR, ROOT


def tiny_copy(dest: Path) -> Path:
    """Copy slam_bench/ and BENCHMARK.json under `dest`, add tiny cells
    next to each real one (`<name>_tiny`), and return the copy's
    slam_bench directory."""
    bench = dest / "slam_bench"
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    new_configs, new_cells = [], []
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["camera"]["width"], cfg["camera"]["height"] = 192, 128
        for side in ("left", "right"):
            cam = cfg["camera"][side]
            cam["fx"], cam["fy"], cam["cx"], cam["cy"] = cam["fx"] / 4, cam["fy"] / 4, cam["cx"] / 4, cam["cy"] / 4
        if "ORBextractor.nFeatures" in cfg:
            cfg["ORBextractor.nFeatures"] = 96
            cfg["ORBextractor.nLevels"] = 2
        cfg["frontend"] = dict(cfg.get("frontend", {}), frame_life=3) if "frontend" in cfg else cfg.get("frontend")
        name = c["name"] + "_tiny"
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        new_configs.append(dict(c, name=name, file=f"slam_bench/configs/{name}.json"))
    for w in spec["workloads"]:
        traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
        traffic = tiny_traffic(traffic)
        tname = w["traffic"] + "_tiny"
        (bench / "traffic" / f"{tname}.json").write_text(json.dumps(traffic))
        name = w["name"] + "_tiny"
        shutil.copy(bench / "limits" / f"{w['name']}.json", bench / "limits" / f"{name}.json")
        new_cells.append(dict(w, name=name, config=w["config"] + "_tiny", traffic=tname))
    spec["configs"] += new_configs
    spec["workloads"] += new_cells
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [w + "_tiny" for w in m["workloads"]]
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return bench


def tiny_traffic(traffic: dict) -> dict:
    t = copy.deepcopy(traffic)
    if t["kind"] == "frontend":
        t["loop_frames"], t["step_m"] = 24, 0.3
        t["warmup_keyframes"] = 2
        t["trace_keyframes"] = 2
        t["reference_batch"] = 3
    if t["kind"] == "ba_offline":
        t["poses"], t["landmarks"] = 12, 240
    return t
