"""The port's keyframe checks (utils/checks.check_keyframe_result and
`FrontendConfig(validate=True)`): the counterparts of tests/test_checks.py's
TestKeyframeChecks, and the check itself against the JAX package's on the
same poisoned results.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vision_slam_frontend_tpu.utils import checks as jchecks  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend import Frontend, FrontendConfig  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend.keyframe import KeyframeResult, StepParams, WindowState, keyframe_step  # noqa: E402,E501
from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig, generate_sequence  # noqa: E402
from vision_slam_frontend_tpu_torch.utils.checks import InvariantViolation, check_keyframe_result  # noqa: E402

CAPACITY = 192


def _config(**kw):
    return FrontendConfig(calib=SyntheticRig().calib(), max_features=CAPACITY, frame_life=4, fast_threshold=12.0,
                          **kw)


def _run_frontend(validate, family="orb", frames=4):
    fe = Frontend(_config(validate=validate, descriptor_family=family), device="cpu")
    for f in generate_sequence(num_frames=frames, step=0.25, rig=SyntheticRig()):
        fe.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
        fe.observe_image(f.left, f.right, f.timestamp)
    return fe


@pytest.fixture(scope="module")
def result():
    """One keyframe's result as numpy arrays, and the image shape."""
    f = next(iter(generate_sequence(num_frames=1, step=0.25, rig=SyntheticRig())))
    config = _config()
    u8 = lambda a: torch.from_numpy(np.clip(a, 0, 255).astype(np.uint8))
    _, r = keyframe_step(StepParams.from_config(config, "cpu"),
                         WindowState.create(4, CAPACITY, config.stereo_threshold_init, "cpu"),
                         u8(f.left), u8(f.right), 0, capacity=CAPACITY, window=4)
    r = KeyframeResult(**{k.name: getattr(r, k.name).numpy() for k in dataclasses.fields(r)})
    assert int(r.num_features) > 40
    return r, f.left.shape[:2]


@pytest.mark.parametrize("family", ["orb", "sift"])
def test_clean_run_passes(family):
    fe = _run_frontend(validate=True, family=family)
    assert fe.get_num_poses() >= 3  # every keyframe checked, none raised


def _poisoned(r):
    """(field, poisoned result, message) cases of tests/test_checks.py."""
    bad_px = np.array(r.pixels_undist)
    bad_px[1] = np.nan
    oob = np.array(r.pixels_raw)
    oob[0] = [1e6, 1e6]
    bad_tid = np.array(r.track_id)
    bad_tid[0] = -5
    far_tid = np.array(r.track_id)
    far_tid[0] = 10 * CAPACITY
    bad_idx = np.array(r.window_curr_idx)
    matched = np.array(r.window_matched)
    matched[0, 0] = True
    bad_idx[0, 0] = CAPACITY - 1
    return [
        (dataclasses.replace(r, pixels_undist=bad_px), "pixels_undist"),
        (dataclasses.replace(r, pixels_raw=oob), "bounds"),
        (dataclasses.replace(r, track_id=bad_tid), "negative track id"),
        (dataclasses.replace(r, track_id=far_tid), "newest possible id"),
        (dataclasses.replace(r, window_curr_idx=bad_idx, window_matched=matched), "invalid feature"),
    ]


def test_nan_pixels_rejected(result):
    r, shape = result
    check_keyframe_result(0, r, shape, CAPACITY)  # clean: passes
    for poisoned, match in _poisoned(r):
        with pytest.raises(InvariantViolation, match=match):
            check_keyframe_result(0, poisoned, shape, CAPACITY)
        with pytest.raises(jchecks.InvariantViolation, match=match):  # the JAX package agrees
            jchecks.check_keyframe_result(0, poisoned, shape, CAPACITY)


def test_count_mismatch_rejected(result):
    r, shape = result
    for n in (500, int(r.num_features) - 1):
        poisoned = dataclasses.replace(r, num_features=np.int32(n))
        with pytest.raises(InvariantViolation, match="num_features" if n == 500 else "popcount"):
            check_keyframe_result(0, poisoned, shape, CAPACITY)


def test_validated_run_equals_unvalidated_run():
    from test_checkpoint import _problems_equal

    a, b = _run_frontend(validate=True, frames=6), _run_frontend(validate=False, frames=6)
    _problems_equal(a.get_slam_problem(), b.get_slam_problem())
    for ta, tb in zip(a.node_track_ids, b.node_track_ids):
        np.testing.assert_array_equal(ta, tb)


def test_validate_fetches_each_keyframe_at_once():
    """In validate mode nothing waits in the one-deep pipeline: the check
    runs at the keyframe that raised it."""
    fe = _run_frontend(validate=True, frames=3)
    assert fe._pending is None and len(fe._nodes) == 2
    fe = _run_frontend(validate=False, frames=3)
    assert fe._pending is not None and len(fe._nodes) == 1


def test_validate_raises_at_the_offending_keyframe(monkeypatch):
    """A poisoned step output raises from observe_image of that keyframe."""
    from vision_slam_frontend_tpu_torch.frontend import frontend as tfrontend

    real = tfrontend.keyframe_step
    calls = []

    def poisoned_step(*args, **kw):
        state, r = real(*args, **kw)
        calls.append(1)
        if len(calls) == 2:
            r = dataclasses.replace(r, points3d=torch.full_like(r.points3d, float("nan")))
        return state, r

    monkeypatch.setattr(tfrontend, "keyframe_step", poisoned_step)
    fe = Frontend(_config(validate=True), device="cpu")
    frames = list(generate_sequence(num_frames=4, step=0.25, rig=SyntheticRig()))
    for i, f in enumerate(frames):
        fe.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
        if i == 2:
            with pytest.raises(InvariantViolation, match="keyframe 1: points3d"):
                fe.observe_image(f.left, f.right, f.timestamp)
            break
        fe.observe_image(f.left, f.right, f.timestamp)


def test_cli_validate(tmp_path):
    from vision_slam_frontend_tpu_torch.cli.slam_frontend import main

    out = tmp_path / "p.npz"
    assert main(["--input", "synthetic:5", "--output", str(out), "--validate", "--max_features", "192",
                 "--device", "cpu"]) == 0 and out.exists()
