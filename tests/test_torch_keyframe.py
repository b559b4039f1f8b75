"""The port's keyframe_step against the JAX package's, teacher-forced at the
default size (640x480, K=512, W=10, ORB, mutual check and guided gate on).

The reference runs keyframes 1..5 of the synthetic sequence; before
keyframe k its WindowState is carried into the port (WindowState.from_numpy)
and both step once from it. Every int and bool field of KeyframeResult and
of the new state must be equal. Float fields: pixels 1e-5 px raw and 1e-3 px
undistorted; stereo_threshold 1e-5 relative; 3D points as in
tests/test_torch_ops.py::test_triangulate_points (on an independent float64
solve of the reference's pixels, and no farther from the reference than its
own float32 error).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from vision_slam_frontend_tpu.frontend import keyframe as jkf  # noqa: E402
from vision_slam_frontend_tpu.frontend.config import FrontendConfig as JaxConfig  # noqa: E402
from vision_slam_frontend_tpu.io.synthetic import SyntheticRig, generate_sequence  # noqa: E402
from vision_slam_frontend_tpu.utils import np_geom  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend import keyframe as tkf  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend import Frontend  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend.config import FrontendConfig  # noqa: E402
from test_torch_ops import check_points, lstsq_triangulate  # noqa: E402

NUM_KEYFRAMES = 5
STEP_KW = dict(capacity=512, window=10, border=19, blur_sigma=2.0, mutual_check=True)
CPU = torch.device("cpu")


def _poses(frames):
    """The Frontend's odometry world pose of each frame, relative to frame 0."""
    q0_inv = np_geom.quat_inverse(np_geom.quat_normalize(frames[0].odom_rotation))
    t0 = frames[0].odom_translation
    out = []
    for f in frames:
        q = np_geom.quat_normalize(f.odom_rotation)
        t = np_geom.quat_rotate(q0_inv, f.odom_translation - t0)
        out.append((t.astype(np.float32), np_geom.quat_multiply(q, q0_inv).astype(np.float32)))
    return out


def _leaves(obj):
    """Field name -> numpy copy, for a JAX pytree dataclass."""
    host = jax.device_get(obj)
    return {f.name: np.array(getattr(host, f.name)) for f in dataclasses.fields(host)}


@pytest.fixture(scope="module")
def trajectory():
    """Per keyframe: (reference state before, step inputs, reference result,
    reference state after), all as numpy."""
    rig = SyntheticRig()
    frames = list(generate_sequence(num_frames=NUM_KEYFRAMES + 1, rig=rig))
    poses = _poses(frames)
    config = JaxConfig(calib=rig.calib(), fast_threshold=12.0)
    params = jkf.StepParams.from_config(config)
    state = jkf.WindowState.create(10, 512, config.stereo_threshold_init)
    out = []
    for k in range(1, NUM_KEYFRAMES + 1):
        left = np.clip(frames[k].left, 0, 255).astype(np.uint8)
        right = np.clip(frames[k].right, 0, 255).astype(np.uint8)
        before = _leaves(state)  # copied: the step donates its state
        state, result = jkf.keyframe_step(
            params, state, left, right, np.int32(k - 1),
            curr_pose_t=poses[k][0], curr_pose_q=poses[k][1], **STEP_KW,
        )
        out.append((before, (left, right, k - 1, poses[k]), _leaves(result), _leaves(state)))
    return out


def _port_step(before, inputs, device=CPU):
    left, right, fid, (pose_t, pose_q) = inputs
    config = FrontendConfig(calib=SyntheticRig().calib(), fast_threshold=12.0)
    params = tkf.StepParams.from_config(config, device)
    state = tkf.WindowState.from_numpy(before, device)
    t = lambda a: torch.from_numpy(a).to(device)
    new_state, result = tkf.keyframe_step(
        params, state, t(left), t(right), fid, curr_pose_t=t(pose_t), curr_pose_q=t(pose_q), **STEP_KW
    )
    return state, new_state, result


def _port_step_in_place(before, inputs):
    """The Frontend's in-place step on a window made from `before`, with the
    frame id as a 0-d int32 tensor (a graph's input): (window, result)."""
    left, right, fid, (pose_t, pose_q) = inputs
    fe = Frontend(FrontendConfig(calib=SyntheticRig().calib(), fast_threshold=12.0), device=CPU)
    fe._state = tkf.WindowState.from_numpy(before, CPU)
    t = torch.from_numpy
    result = fe._step(t(left), t(right), torch.cat([t(pose_t), t(pose_q)]), torch.tensor(fid, dtype=torch.int32))
    return fe._state, result


def _as_numpy(obj):
    out = {f.name: getattr(obj, f.name).cpu().numpy() for f in dataclasses.fields(obj)}
    if "desc" in out:
        out["desc"] = out["desc"].view(np.uint32)
    return out


def _exact_points(ref_result):
    """Float64 solve of the reference's undistorted stereo pairs; zero rows
    where the reference has no feature."""
    config = FrontendConfig(calib=SyntheticRig().calib())
    valid = ref_result["feat_valid"]
    exact = np.zeros((len(valid), 3))
    exact[valid] = lstsq_triangulate(config.P_left, config.P_right,
                                     ref_result["pixels_undist"][valid], ref_result["right_pixels_undist"][valid])
    return exact


def _check_points(out, ref, exact):
    real = np.linalg.norm(ref, axis=-1) > 0
    np.testing.assert_array_equal(out[~real], 0.0)
    check_points(out[real], ref[real], exact[real])


FLOAT_ATOL = {
    "pixels_raw": 1e-5, "right_pixels_raw": 1e-5, "kps": 1e-5,
    "pixels_undist": 1e-3, "right_pixels_undist": 1e-3,
    "window_match_dist": 0.0, "pose_t": 0.0, "pose_q": 0.0,
}


def _compare(out, ref, what, exact_points=None):
    assert out.keys() == ref.keys(), what
    for name, b in ref.items():
        a = out[name]
        assert a.shape == b.shape, (what, name, a.shape, b.shape)
        if b.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f"{what}.{name}")
        elif name == "points3d":
            _check_points(a, b, exact_points)
        elif name == "stereo_threshold":
            np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=f"{what}.{name}")
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=FLOAT_ATOL[name], err_msg=f"{what}.{name}")


@pytest.mark.parametrize("k", range(1, NUM_KEYFRAMES + 1))
def test_keyframe_step_teacher_forced(trajectory, k):
    before, inputs, ref_result, ref_state = trajectory[k - 1]
    state, new_state, result = _port_step(before, inputs)
    res = _as_numpy(result)
    exact = _exact_points(ref_result)
    _compare(res, ref_result, "KeyframeResult", exact)
    state_exact = ref_state["points3d"].astype(np.float64)
    state_exact[ref_state["frame_id"] == inputs[2]] = exact
    _compare(_as_numpy(new_state), ref_state, "WindowState", state_exact)
    assert res["num_features"] > 100
    if k > 1:
        assert res["window_matched"].sum() > 10 and (res["track_id"] != np.arange(512) + (k - 1) * 512).any()
    # The caller's state is not touched.
    _compare(_as_numpy(state), {**before, "desc": before["desc"].view(np.uint32)}, "input state",
             before["points3d"])


def test_window_state_from_checkpoint_keys(trajectory):
    """The reference's checkpoint key names give the same state."""
    before = trajectory[3][0]
    ckpt = {("ckpt_stereo_threshold" if n == "stereo_threshold" else f"ckpt_window_{n}"): v
            for n, v in before.items()}
    a = tkf.WindowState.from_numpy(before, CPU)
    b = tkf.WindowState.from_numpy(ckpt, CPU)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert a.desc.dtype == torch.int32
    np.testing.assert_array_equal(_as_numpy(a)["desc"], before["desc"])
    with pytest.raises(KeyError, match="pose_q"):
        tkf.WindowState.from_numpy({k: v for k, v in before.items() if k != "pose_q"}, CPU)


def test_step_params_from_config():
    config = FrontendConfig(guided_match_radius=0.0, nn_match_ratio=0.7)
    p = tkf.StepParams.from_config(config, CPU)
    assert p.guided_radius.item() == 0.0 and p.nn_match_ratio.dtype == torch.float32
    assert torch.equal(p.cam_R, torch.from_numpy(config.left_cam_to_robot[:3, :3]))
    assert p.intr_left == config.intrinsics_left


def test_guided_gate_off_matches_no_pose(trajectory):
    """guided_radius <= 0 turns the gate off: the same matches as a step
    that is given no pose at all."""
    before, (left, right, fid, pose), _, _ = trajectory[2]
    config = FrontendConfig(calib=SyntheticRig().calib(), fast_threshold=12.0, guided_match_radius=0.0)
    params = tkf.StepParams.from_config(config, CPU)
    state = tkf.WindowState.from_numpy(before, CPU)
    t = torch.from_numpy
    _, r_gate_off = tkf.keyframe_step(params, state, t(left), t(right), fid,
                                      curr_pose_t=t(pose[0]), curr_pose_q=t(pose[1]), **STEP_KW)
    new_state, r_no_pose = tkf.keyframe_step(params, state, t(left), t(right), fid, **STEP_KW)
    assert torch.equal(r_gate_off.window_matched, r_no_pose.window_matched)
    assert torch.equal(new_state.pose_q[2], torch.tensor([1.0, 0.0, 0.0, 0.0]))


def _assert_fields_equal(a, b):
    for f in dataclasses.fields(b):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


@pytest.mark.parametrize("k", range(1, 4))
def test_a_tensor_frame_id_gives_the_int_ones_step(trajectory, k):
    """The frame id as a 0-d int32 tensor (what a graph replay reads) gives
    the step of the Python int, every field of the result and the state."""
    before, (left, right, fid, pose), _, _ = trajectory[k - 1]
    _, state_int, result_int = _port_step(before, (left, right, fid, pose))
    _, state_t, result_t = _port_step(before, (left, right, torch.tensor(fid, dtype=torch.int32), pose))
    _assert_fields_equal(result_t, result_int)
    _assert_fields_equal(state_t, state_int)
    assert (state_t.frame_id == fid).sum() == 1


@pytest.mark.parametrize("k", [2, 4])
def test_the_in_place_step_writes_the_returned_state(trajectory, k):
    """The Frontend's step leaves in its window what keyframe_step returns,
    gives the same result, and its window_frame_id is the pre-update row,
    held apart from the window it wrote."""
    before, inputs, _, _ = trajectory[k - 1]
    _, new_state, result = _port_step(before, inputs)
    window, result_in_place = _port_step_in_place(before, inputs)
    _assert_fields_equal(window, new_state)
    _assert_fields_equal(result_in_place, result)
    np.testing.assert_array_equal(result_in_place.window_frame_id.numpy(), before["frame_id"])
    assert result_in_place.window_frame_id.data_ptr() != window.frame_id.data_ptr()
    assert not torch.equal(window.frame_id, result_in_place.window_frame_id)
