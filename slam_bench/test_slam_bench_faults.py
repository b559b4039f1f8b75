"""A run with its timed path broken underneath comes out not correct. Each
test skips the look for a card (device "cpu", a tiny cell) and drives the
rest of the run with one fault planted in the program: a step that returns
its state unchanged, half of the work left out, an answer altered where it
is produced. No cell exchanges anything between chips, so that fault has no
test here."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from slam_bench import run
from slam_bench.tiny import tiny_copy

FRONTEND_CELLS = ["kitti_orb2000_replay", "euroc_orb1200_png", "kitti_orb2000_local_ba8"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("tiny"))


def _step_fault(kind):
    from vision_slam_frontend_tpu_torch.frontend import keyframe as kf_mod

    real = kf_mod.keyframe_step

    def step(params, state, *args, **kwargs):
        new_state, result = real(params, state, *args, **kwargs)
        if kind == "state_unchanged":
            return state, result
        if kind == "half_left_out":
            return new_state, dataclasses.replace(result, num_features=result.num_features // 2)
        track = result.track_id.clone()
        track[0] += 1
        return new_state, dataclasses.replace(result, track_id=track)

    return step


def _correct(bench, cell, seconds=4.0):
    return run.run_cell(f"{cell}_tiny", 4242, seconds, False, device="cpu", bench_dir=bench)["correct"]


@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out", "answer_altered"])
@pytest.mark.parametrize("cell", FRONTEND_CELLS)
def test_a_broken_keyframe_step_is_not_correct(bench, monkeypatch, cell, kind):
    from vision_slam_frontend_tpu_torch.frontend import frontend as fe_mod

    monkeypatch.setattr(fe_mod, "keyframe_step", _step_fault(kind))
    assert _correct(bench, cell, 8.0 if cell.endswith("local_ba8") else 4.0) is False


def test_an_altered_decoded_image_is_not_correct(bench, monkeypatch):
    from vision_slam_frontend_tpu_torch.io import euroc

    real = euroc.load_gray

    def load_gray(path):
        img = real(path)
        img[0, 0] = 255.0 - img[0, 0]
        return img

    monkeypatch.setattr(euroc, "load_gray", load_gray)
    assert _correct(bench, "euroc_orb1200_png", 3.0) is False


@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out", "answer_altered"])
def test_a_broken_local_solve_is_not_correct(bench, monkeypatch, kind):
    from vision_slam_frontend_tpu_torch.backend import local_ba

    real = local_ba._device_lm_solve

    def solve(cam, prob, *args):
        pt, pq, c0, c, acc = real(cam, prob, *args)
        if kind == "state_unchanged":
            return prob.poses_t, prob.poses_q, c0, c, acc
        if kind == "half_left_out":
            half = pt.shape[0] // 2
            return torch.cat([pt[:half], prob.poses_t[half:]]), torch.cat([pq[:half], prob.poses_q[half:]]), c0, c, acc
        pt = pt.clone()
        pt[-1, 0] += 0.05
        return pt, pq, c0, c, acc

    monkeypatch.setattr(local_ba, "_device_lm_solve", solve)
    assert _correct(bench, "kitti_orb2000_local_ba8") is False


@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out", "answer_altered"])
def test_a_broken_ba_solve_is_not_correct(bench, monkeypatch, kind):
    from vision_slam_frontend_tpu_torch.backend import ba

    real = ba.optimize

    def optimize(problem, *args, **kwargs):
        out, info = real(problem, *args, **kwargs)
        if kind == "state_unchanged":
            return problem, info
        if kind == "half_left_out":
            half = problem.landmarks.shape[0] // 2
            return out.replace(landmarks=torch.cat([out.landmarks[:half], problem.landmarks[half:]])), info
        t = out.poses_t.clone()
        t[3, 0] += 0.5
        return out.replace(poses_t=t), info

    monkeypatch.setattr(ba, "optimize", optimize)
    assert _correct(bench, "kitti_ba_p500_l100k", 1.0) is False
