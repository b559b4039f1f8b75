"""The port's keyframe checks (utils/checks.check_keyframe_result and
`FrontendConfig(validate=True)`): the counterparts of tests/test_checks.py's
TestKeyframeChecks, and the check itself against the JAX package's on the
same poisoned results. `checkified` against jax.experimental.checkify (the
JAX package's `checkified`): the same verdict, error or none, on each case.
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
from vision_slam_frontend_tpu_torch.utils.checks import InvariantViolation, check_keyframe_result, checkified  # noqa: E402,E501

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


def _jax_checkified(fn, *args, errors=None, **static):
    import functools

    import jax
    from jax.experimental import checkify

    errors = errors or (checkify.float_checks | checkify.index_checks)  # the JAX package's set
    return jax.jit(checkify.checkify(functools.partial(fn, **static), errors=errors))(*args)


def _small_cases():
    import jax.numpy as jnp

    return {
        "clean": (lambda m: (lambda x: m.log(x) / m.sum(x)), [np.float32([1.0, 2.0, 3.0])]),
        "log_negative": (lambda m: (lambda x: m.log(x) / m.sum(x)), [np.float32([-1.0, 2.0, 3.0])]),
        "sqrt_negative": (lambda m: m.sqrt, [np.float32([4.0, -1.0])]),
        "zero_over_zero": (lambda m: (lambda x, y: x / y), [np.float32([0.0, 1.0]), np.float32([0.0, 2.0])]),
        "one_over_zero": (lambda m: (lambda x, y: x / y), [np.float32([1.0, 1.0]), np.float32([0.0, 2.0])]),
        "integer_division_by_zero": (lambda m: (lambda x, y: x // y), [np.int32([3, 4]), np.int32([0, 2])]),
        "gather_out_of_range": (lambda m: (lambda x, i: x[i]), [np.float32([0, 1, 2, 3]), np.int32([1, 4])]),
        "gather_in_range": (lambda m: (lambda x, i: x[i]), [np.float32([0, 1, 2, 3]), np.int32([1, -4])]),
        "nan_in_input": (lambda m: (lambda x: x * 2.0), [np.float32([np.nan, 1.0])]),
    }, jnp


@pytest.mark.parametrize("case", list(_small_cases()[0]))
def test_checkified_verdict_equals_the_jax_packages(case):
    cases, jnp = _small_cases()
    make, inputs = cases[case]
    ours, _ = checkified(make(torch), *[torch.from_numpy(a) for a in inputs])
    theirs, _ = _jax_checkified(make(jnp), *[jnp.asarray(a) for a in inputs])
    assert (ours.get() is None) == (theirs.get() is None), (ours.get(), theirs.get())
    assert (ours.get() is None) == (case in ("clean", "gather_in_range"))
    if ours.get() is not None:
        with pytest.raises(InvariantViolation):
            ours.throw()
    else:
        ours.throw()  # no error: nothing raised


def test_checkified_messages_name_the_op():
    assert checkified(torch.sqrt, torch.tensor([-1.0]))[0].get() == "nan generated by aten.sqrt"
    assert checkified(lambda x, y: x // y, torch.tensor([3]), torch.tensor([0]))[0].get() == \
        "division by zero in aten.floor_divide"
    assert checkified(lambda x, y: torch.div(x, y, rounding_mode="trunc"), torch.tensor([3]),
                      torch.tensor([0]))[0].get() == "division by zero in aten.div"
    assert checkified(lambda x, y: x % y, torch.tensor([3]), torch.tensor([0]))[0].get() == \
        "division by zero in aten.remainder"
    assert checkified(lambda x: 1.0 / x, torch.tensor([2.0, 0.0]))[0].get() == "division by zero in aten.reciprocal"
    assert checkified(lambda x: x / 0.0, torch.tensor([2.0]))[0].get() == "division by zero in aten.div"


@pytest.mark.parametrize("op", ["index", "index_select", "gather", "take", "scatter", "scatter_add", "index_put",
                                "index_add"])
def test_checkified_stops_before_an_out_of_range_index(op):
    """The op is not dispatched (on CUDA it would be a device-side assert):
    the function stops there with a message, and the result is None."""
    x = torch.arange(6.0).reshape(2, 3)
    bad = torch.tensor([[0, 3]])
    ran = []
    fns = {
        "index": lambda: x[:, bad[0]],
        "index_select": lambda: x.index_select(1, bad[0]),
        "gather": lambda: x.gather(1, bad),
        "take": lambda: x.take(torch.tensor([6])),
        "scatter": lambda: x.scatter(1, bad, torch.ones(1, 2)),
        "scatter_add": lambda: x.scatter_add(1, bad, torch.ones(1, 2)),
        "index_put": lambda: x.index_put((torch.tensor([2]),), torch.tensor(1.0)),
        "index_add": lambda: x.index_add(1, bad[0], torch.ones(2, 2)),
    }

    def fn():
        out = fns[op]()
        ran.append(1)
        return out

    err, result = checkified(fn)
    assert result is None and not ran
    assert "out-of-bounds index" in err.get()
    assert checkified(lambda: x[:, torch.tensor([0, -3])])[0].get() is None  # negative indices count from the end


def _step_inputs(nan_pose: bool):
    f = next(iter(generate_sequence(num_frames=1, step=0.25, rig=SyntheticRig())))
    left, right = (np.clip(im, 0, 255).astype(np.uint8) for im in (f.left, f.right))
    pose_t = np.zeros(3, np.float32)
    if nan_pose:
        pose_t[1] = np.nan
    return left, right, pose_t, np.float32([1, 0, 0, 0])


def _port_step(nan_pose: bool, checked: bool):
    left, right, pose_t, pose_q = _step_inputs(nan_pose)
    config = _config()
    args = (StepParams.from_config(config, "cpu"), WindowState.create(4, CAPACITY, config.stereo_threshold_init, "cpu"),
            torch.from_numpy(left), torch.from_numpy(right), 0)
    kw = dict(capacity=CAPACITY, window=4, curr_pose_t=torch.from_numpy(pose_t), curr_pose_q=torch.from_numpy(pose_q))
    if checked:
        return checkified(keyframe_step, *args, **kw)
    return keyframe_step(*args, **kw)


def _jax_step(nan_pose: bool, errors=None):
    import jax.numpy as jnp

    from vision_slam_frontend_tpu.frontend.config import FrontendConfig as JaxConfig
    from vision_slam_frontend_tpu.frontend.keyframe import StepParams as JaxParams
    from vision_slam_frontend_tpu.frontend.keyframe import WindowState as JaxState
    from vision_slam_frontend_tpu.frontend.keyframe import keyframe_step as jax_step

    left, right, pose_t, pose_q = _step_inputs(nan_pose)
    config = JaxConfig(calib=SyntheticRig().calib(), max_features=CAPACITY, frame_life=4, fast_threshold=12.0)
    err, _ = _jax_checkified(jax_step, JaxParams.from_config(config), JaxState.create(4, CAPACITY, 10000.0),
                             jnp.asarray(left), jnp.asarray(right), jnp.int32(0), errors=errors, capacity=CAPACITY,
                             window=4, curr_pose_t=jnp.asarray(pose_t), curr_pose_q=jnp.asarray(pose_q))
    return err.get()


def test_checkified_clean_keyframe_step():
    """A clean step: no error in the port, and the checked step's result
    equals the plain step's. The JAX package's float checks find nothing
    either; its index checks report one out-of-range index, K, which is the
    parked slot of its dropped scatter (keyframe.py's `mode="drop"` track-id
    write), a write the port's step does not make (it parks in a K + 1
    buffer)."""
    from jax.experimental import checkify

    err, (state, result) = _port_step(nan_pose=False, checked=True)
    assert err.get() is None
    plain_state, plain = _port_step(nan_pose=False, checked=False)
    for f in dataclasses.fields(result):
        a, b = getattr(result, f.name), getattr(plain, f.name)
        assert torch.equal(a, b) if not a.is_floating_point() else torch.allclose(a, b, equal_nan=True), f.name
    assert torch.equal(state.track_id, plain_state.track_id)
    assert _jax_step(False, errors=checkify.float_checks) is None
    assert f"index {CAPACITY} is out of bounds for axis 0 with size {CAPACITY}" in _jax_step(False)


def test_checkified_nan_pose_keyframe_step():
    """A NaN in curr_pose_t: an error in both packages, naming the op."""
    err, _ = _port_step(nan_pose=True, checked=True)
    assert err.get() is not None and err.get().startswith("nan generated by aten.")
    assert _jax_step(True) is not None
