"""The plain reference held to the port at a small size on the CPU (this
test may import both; the reference itself imports neither the port nor
JAX)."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_bench import run, scene
from slam_bench.drivers.frontend import frontend_settings
from slam_bench.reference import frontend_ref
from slam_bench.tiny import tiny_copy

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


def test_the_reference_imports_nothing_of_the_port_or_jax():
    for path in (ROOT / "slam_bench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "vision_slam_frontend_tpu",
                                                  "vision_slam_frontend_tpu_torch"), (path.name, name)


@pytest.mark.parametrize("config,traffic", [("kitti_stereo_orb2000", "car_loop_replay"),
                                            ("euroc_mav_orb1200", "mav_loop_png")])
def test_detection_and_description_equal_the_ports(config, traffic):
    from vision_slam_frontend_tpu_torch.ops.brief import detect_and_describe

    cfg = json.loads((ROOT / "slam_bench" / "configs" / f"{config}.json").read_text())
    cfg["camera"]["width"], cfg["camera"]["height"] = 256, 160
    cfg["ORBextractor.nFeatures"] = 240
    tr = json.loads((ROOT / "slam_bench" / "traffic" / f"{traffic}.json").read_text())
    left, right = scene.Renderer(cfg, tr, 31, "cpu").frames([0.4])
    s = frontend_settings(cfg)
    images = torch.cat([left, right])
    kps, desc, valid, _ = frontend_ref.extract(images, s, frontend_ref._brief_tables(torch.device("cpu")))
    for i in range(2):
        p_kps, _, p_desc, p_valid = detect_and_describe(
            images[i], threshold=torch.tensor(s["fast_threshold"]), max_keypoints=s["max_features"],
            border=s["detect_border"], blur_sigma=s["blur_sigma"], num_levels=s["num_levels"],
            scale_factor=s["pyramid_scale"])
        assert torch.equal(p_valid, valid[i]) and int(valid[i].sum()) > 100
        assert torch.equal(p_kps, kps[i])
        assert torch.equal(p_desc, desc[i])


@pytest.mark.parametrize("cell", ["kitti_orb2000_replay", "euroc_orb1200_png"])
def test_every_keyframe_of_a_tiny_run_equals_the_reference(bench, cell):
    res = run.run_cell(f"{cell}_tiny", 77, 1.5, False, device="cpu", bench_dir=bench)
    got = {k: c["value"] for k, c in res["checks"].items()}
    assert got["keyframe_gap"] == 0 and got["feature_mismatches"] == 0 and got["match_mismatches"] == 0
    assert got["descriptor_mismatches"] == 0 and got["point_gap_rel"] == 0.0


def test_local_ba_follows_the_reference(bench):
    res = run.run_cell("kitti_orb2000_local_ba8_tiny", 78, 2.0, False, device="cpu", bench_dir=bench)
    assert res["checks"]["local_ba_pose_gap_m"]["value"] < 1e-3
    assert res["checks"]["local_ba_rotation_gap"]["value"] < 1e-6


def test_offline_ba_follows_the_reference(bench):
    res = run.run_cell("kitti_ba_p500_l100k_tiny", 79, 1.0, False, device="cpu", bench_dir=bench)
    got = {k: c["value"] for k, c in res["checks"].items()}
    assert got["cost_gap"] < 1e-4 and got["reported_cost_gap"] < 1e-5 and got["pose_gap_m"] < 1e-3
