"""CPU tests of the benchmark harness (run them with
`python -m pytest slam_bench -q`; the repository's tier-1 run does not
collect them). Each tiny cell is a copy of a real one at a small size,
added as files and entries only (slam_bench/tiny.py)."""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from slam_bench import common, run, scene
from slam_bench.tiny import tiny_copy

ROOT = Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_cell_runs_end_to_end_on_the_cpu(bench, cell):
    res = run.run_cell(f"{cell}_tiny", 2**31 + 11, 1.5, False, device="cpu", bench_dir=bench)
    assert res["correct"] is True, res["checks"]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert res["attempted"] > 0 and res["failed"] == 0
    spec = common.load_cell(f"{cell}_tiny", bench)
    assert set(res["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == set(spec["limits"]["limits"])
    json.dumps({k: v for k, v in res.items() if k != "notes"})


def test_a_traced_tiny_run_reads_its_host_spans(bench):
    res = run.run_cell("euroc_orb1200_png_tiny", 7, 1.5, True, device="cpu", bench_dir=bench)
    assert {"io.decode_ms", "frontend.observe_ms"} <= set(res["metrics"])
    # Device figures come from the card alone: nothing is read from a CPU run.
    assert not {"keyframe.launches", "keyframe.device_ms", "device.idle_share.frontend"} & set(res["metrics"])
    assert "busy_s" not in res["device"] and "breakdown" not in res


def _run_command(cwd: Path, *args) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "slam_bench/run.py", *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_the_command_refuses_to_measure_without_a_card():
    p = _run_command(ROOT, "--workload", CELLS[0], "--seed", "3", "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "torch.cuda.is_available() is false" in p.stderr


def test_the_command_fails_where_only_the_benchmark_is(tmp_path):
    (tmp_path / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    import shutil

    shutil.copytree(ROOT / "slam_bench", tmp_path / "slam_bench", ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_command(tmp_path, "--workload", CELLS[0], "--seed", "3", "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    # Past the look for a card, the run needs the port, which is not there.
    script = ("import sys; sys.path.insert(0, %r)\nfrom slam_bench import run\n"
              "run.run_cell(%r, 3, 1.0, False, device='cpu')\n") % (str(tmp_path), CELLS[0])
    p = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and "No module named 'vision_slam_frontend_tpu_torch'" in p.stderr


def test_configs_traffic_limits_and_metrics_are_found_by_name(bench):
    """A cell, a configuration, a traffic mix, its limits and a per-layer
    metric added as files and entries run with no file of the harness
    edited."""
    code = {p.relative_to(bench): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in bench.rglob("*.py") if "__pycache__" not in p.parts}
    (bench / "layer_metrics" / "tiny.keyframes_read.py").write_text(
        "def read(ctx):\n    return float(len(ctx['ref_results'])) if ctx.get('kind') == 'frontend' else None\n")
    spec = json.loads((bench.parent / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "tiny.keyframes_read", "unit": "keyframes", "better": "higher",
                              "source": "program_counter", "layer": "host driver", "moves": "frames_per_s",
                              "workloads": ["kitti_orb2000_replay_tiny"]})
    (bench.parent / "BENCHMARK.json").write_text(json.dumps(spec))
    res = run.run_cell("kitti_orb2000_replay_tiny", 5, 1.0, True, device="cpu", bench_dir=bench)
    assert res["metrics"]["tiny.keyframes_read"]["value"] > 0
    after = {p.relative_to(bench): hashlib.sha256(p.read_bytes()).hexdigest()
             for p in bench.rglob("*.py") if "__pycache__" not in p.parts and p.name != "tiny.keyframes_read.py"}
    assert after == code
    assert (bench / "configs" / "kitti_stereo_orb2000_tiny.json").is_file()
    assert (bench / "traffic" / "car_loop_replay_tiny.json").is_file()


PACED_INPUT = '''"""Frames in memory offered at the camera's rate, open loop: frame g
arrives g / rate after the first; its latency counts from its arrival."""

import time


def start(ctx):
    frames, stream = ctx["frames"], ctx["stream"]

    def events():
        t0 = t_first = None
        for kind, t, payload in stream.events(1 << 40):
            if kind != "stereo":
                yield kind, t, payload
                continue
            if t0 is None:
                t0, t_first = time.perf_counter(), t
            due = t0 + (t - t_first)
            time.sleep(max(due - time.perf_counter(), 0.0))
            yield kind, t, frames[payload], due

    return dict(calib=ctx["calib"], events=events(), close=lambda: None)
'''

PCG_KIND = '''"""Offline BA through the matrix-free PCG route, whatever the size."""

from slam_bench.common import load_module


def run(cell, seed, seconds, trace, t_process0, device="cuda"):
    traffic = dict(cell["traffic"], solver=dict(cell["traffic"].get("solver", {}), schur_solver="pcg"))
    base = load_module(cell["bench_dir"], "drivers", "ba_offline")
    return base.run(dict(cell, traffic=traffic), seed, seconds, trace, t_process0, device=device)
'''


def test_a_new_traffic_kind_input_and_solver_are_files_and_entries_only(bench):
    """A traffic kind (drivers/), a frontend input (inputs/) and the BA
    solver's settings added as files and entries run with no file of the
    harness edited: an open-loop input paced at the camera's rate, a PCG
    driver, and a traffic file that picks PCG by data alone."""
    code = {p.relative_to(bench): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in bench.rglob("*.py") if "__pycache__" not in p.parts}
    (bench / "inputs" / "memory_paced.py").write_text(PACED_INPUT)
    (bench / "drivers" / "ba_offline_pcg.py").write_text(PCG_KIND)
    spec = json.loads((bench.parent / "BENCHMARK.json").read_text())
    fe = json.loads((bench / "traffic" / "car_loop_replay_tiny.json").read_text())
    ba = json.loads((bench / "traffic" / "ba_offline_p500_l100k_tiny.json").read_text())
    new = {"car_paced_tiny": (dict(fe, input="memory_paced"), "kitti_stereo_orb2000_tiny", "kitti_orb2000_replay"),
           "ba_pcg_kind_tiny": (dict(ba, kind="ba_offline_pcg"), "kitti_stereo_orb2000_tiny", "kitti_ba_p500_l100k"),
           "ba_pcg_data_tiny": (dict(ba, solver={"schur_solver": "pcg", "cg_iterations": 96}),
                                "kitti_stereo_orb2000_tiny", "kitti_ba_p500_l100k")}
    for traffic, (body, config, like) in new.items():
        (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(body))
        (bench / "limits" / f"{traffic}_cell.json").write_text((bench / "limits" / f"{like}.json").read_text())
        spec["workloads"].append({"name": f"{traffic}_cell", "config": config, "traffic": traffic, "chips": 1,
                                  "why": "added as files and entries"})
        for m in spec["end_to_end"]:
            if like in m.get("workloads", []):
                m["workloads"].append(f"{traffic}_cell")
    (bench.parent / "BENCHMARK.json").write_text(json.dumps(spec))
    for traffic in new:
        res = run.run_cell(f"{traffic}_cell", 2**31 + 17, 1.0, False, device="cpu", bench_dir=bench)
        assert res["correct"] is True, (traffic, res["checks"])
        assert res["attempted"] > 0
    after = {p.relative_to(bench): hashlib.sha256(p.read_bytes()).hexdigest()
             for p in bench.rglob("*.py") if "__pycache__" not in p.parts
             and p.name not in ("memory_paced.py", "ba_offline_pcg.py")}
    assert after == code


def test_a_solver_setting_the_reference_does_not_follow_is_refused(bench):
    spec = json.loads((bench.parent / "BENCHMARK.json").read_text())
    ba = json.loads((bench / "traffic" / "ba_offline_p500_l100k_tiny.json").read_text())
    (bench / "traffic" / "ba_huber_tiny.json").write_text(json.dumps(dict(ba, solver={"huber_delta": 2.0})))
    (bench / "limits" / "ba_huber_tiny_cell.json").write_text(
        (bench / "limits" / "kitti_ba_p500_l100k.json").read_text())
    spec["workloads"].append({"name": "ba_huber_tiny_cell", "config": "kitti_stereo_orb2000_tiny",
                              "traffic": "ba_huber_tiny", "chips": 1, "why": "a setting the reference lacks"})
    (bench.parent / "BENCHMARK.json").write_text(json.dumps(spec))
    with pytest.raises(common.Refused, match="huber_delta"):
        run.run_cell("ba_huber_tiny_cell", 3, 1.0, False, device="cpu", bench_dir=bench)


@pytest.mark.parametrize("config,traffic", [("kitti_stereo_orb2000", "car_loop_replay"),
                                            ("euroc_mav_orb1200", "mav_loop_png")])
def test_the_scene_is_bit_identical_for_a_seed_and_differs_across_seeds(config, traffic):
    cfg = json.loads((ROOT / "slam_bench" / "configs" / f"{config}.json").read_text())
    cfg["camera"]["width"], cfg["camera"]["height"] = 160, 96
    tr = json.loads((ROOT / "slam_bench" / "traffic" / f"{traffic}.json").read_text())
    a = scene.Renderer(cfg, tr, 2**31 + 5, "cpu").frames([0.1, 0.2])
    b = scene.Renderer(cfg, tr, 2**31 + 5, "cpu").frames([0.1, 0.2])
    c = scene.Renderer(cfg, tr, 2**31 + 6, "cpu").frames([0.1, 0.2])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert float(a[0].float().std(dim=1).min()) > 5.0  # every row carries texture


def test_nothing_the_run_loads_is_jax_or_the_jax_package(bench):
    """A subprocess drives a tiny run and then lists every loaded module's
    top-level name; the port's own name shares the JAX package's prefix."""
    script = (
        "import sys; sys.path.insert(0, %r)\n"
        "from pathlib import Path\n"
        "from slam_bench import run, common\n"
        "run.run_cell('euroc_orb1200_png_tiny', 9, 1.0, True, device='cpu', bench_dir=Path(%r))\n"
        "tops = {m.split('.')[0] for m in list(sys.modules)}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'vision_slam_frontend_tpu'}))\n"
        "print('vision_slam_frontend_tpu_torch' in tops, common.forbidden_modules())\n"
    ) % (str(ROOT), str(bench))
    p = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split("\n")[-3:-1] == ["[]", "True []"]


def test_the_import_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "vision_slam_frontend_tpu_torch_like", object())
    assert common.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert common.forbidden_modules() == ["jax"]
    monkeypatch.setitem(sys.modules, "vision_slam_frontend_tpu.ops", object())
    assert common.forbidden_modules() == ["jax", "vision_slam_frontend_tpu"]


def test_the_95th_percentile_is_the_nearest_rank():
    assert common.p95(list(range(1, 101))) == 95
    assert common.p95([3.0]) == 3.0
    assert common.p95(list(range(20, 0, -1))) == 19
