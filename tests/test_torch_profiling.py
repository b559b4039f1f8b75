"""The port's stage profiling (utils/profiling.py, cli/profile_stages.py):
tests/test_profiling.py's two cases run on the port, with the stage keys of
the JAX package's own function at the same size."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vision_slam_frontend_tpu.frontend.config import FrontendConfig as JaxConfig  # noqa: E402
from vision_slam_frontend_tpu.utils.profiling import profile_keyframe_stages as jax_profile  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend.config import FrontendConfig  # noqa: E402
from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig  # noqa: E402
from vision_slam_frontend_tpu_torch.utils.profiling import format_stage_table, profile_keyframe_stages  # noqa: E402

EXPECTED_STAGES = {"detect_describe_x2", "stereo_ratio_match", "epipolar_filter", "window_match", "undistort_x2",
                   "triangulate"}
SMALL = dict(max_features=128, frame_life=3, fast_threshold=12.0)


def test_profile_stages_smoke():
    rig = SyntheticRig(width=320, height=240)
    t = profile_keyframe_stages(FrontendConfig(calib=rig.calib(), **SMALL), image_shape=(240, 320), iters=2,
                                windows=1, device="cpu")
    theirs = jax_profile(JaxConfig(calib=rig.calib(), **SMALL), image_shape=(240, 320), iters=1, windows=1)
    assert set(t) == set(theirs)  # the 12 stages, _stage_sum_ms and _fused_step_ms (no enqueue time on the CPU)
    assert EXPECTED_STAGES <= set(t) and len([k for k in t if not k.startswith("_")]) == 12
    assert all(v > 0 for v in t.values())
    table = format_stage_table(t)
    assert "fused keyframe step" in table
    for s in EXPECTED_STAGES:
        assert s in table
    table = format_stage_table(dict(t, _fused_step_enqueue_ms=0.5))
    assert "of which enqueue" in table


@pytest.mark.parametrize("device_flag", [["--cpu"], ["--device", "cpu"]])
def test_profile_cli(capsys, tmp_path, device_flag):
    from vision_slam_frontend_tpu_torch.cli.profile_stages import TRACE_FILE, main

    rc = main(device_flag + ["--max_features", "128", "--frame_life", "3", "--width", "320", "--height", "240",
                             "--iters", "1", "--windows", "1", "--trace_dir", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "detect_describe_x2" in out and "on cpu" in out and f"Wrote profiler trace to {tmp_path}" in out
    assert (tmp_path / TRACE_FILE).exists()
