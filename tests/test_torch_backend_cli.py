"""The port's BA backend as a whole against the JAX package's, on the CPU:
track building on the port's own synthetic:20 frontend output, the
slam_backend CLI, and optimize on tests/test_drift_correction.py's problem.
Helpers and conventions: tests/test_torch_backend.py.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from tests.test_torch_backend import CPU, port_problem  # noqa: E402
from vision_slam_frontend_tpu.backend import ba as jba  # noqa: E402
from vision_slam_frontend_tpu.backend import metrics as jmetrics  # noqa: E402
from vision_slam_frontend_tpu.backend import residuals as jres  # noqa: E402
from vision_slam_frontend_tpu.backend import tracks as jtracks  # noqa: E402
from vision_slam_frontend_tpu.io import serialize as jser  # noqa: E402
from vision_slam_frontend_tpu_torch.backend import ba  # noqa: E402
from vision_slam_frontend_tpu_torch.backend import metrics  # noqa: E402
from vision_slam_frontend_tpu_torch.backend import residuals as res  # noqa: E402
from vision_slam_frontend_tpu_torch.backend import tracks  # noqa: E402
from vision_slam_frontend_tpu_torch.io import serialize  # noqa: E402


@pytest.fixture(scope="module")
def frontend_npz(tmp_path_factory):
    """The port's own synthetic:20 frontend output (the CLI on the CPU)."""
    from vision_slam_frontend_tpu_torch.cli import slam_frontend

    path = str(tmp_path_factory.mktemp("fe") / "synthetic20.npz")
    assert slam_frontend.main(["--input", "synthetic:20", "--output", path, "--device", "cpu"]) == 0
    return path


def test_build_ba_problem_equals_the_jax_packages(frontend_npz):
    """Track building on the port's synthetic:20 problem: every array equal
    (the same numpy code; integer tables, masks and floats alike)."""
    with np.load(frontend_npz) as raw:
        ext = raw["calib_left_cam_to_robot"]
    theirs = jtracks.build_ba_problem(jser.load_problem(frontend_npz), left_cam_to_robot=ext)
    ours = tracks.build_ba_problem(serialize.load_problem(frontend_npz), left_cam_to_robot=ext, device=CPU)
    mine = ours.to_numpy()
    assert int(ours.landmark_mask.sum()) > 200
    for f in theirs.__dataclass_fields__:
        v = getattr(theirs, f)
        if v is None:
            assert f not in mine
            continue
        v = np.asarray(v)
        assert mine[f].dtype == v.dtype and mine[f].shape == v.shape, f
        np.testing.assert_array_equal(mine[f], v, err_msg=f)
    po, pom, lo, lom = tracks.build_gather_tables(mine["obs_pose"], mine["obs_landmark"], mine["obs_mask"],
                                                  ours.num_poses, ours.num_landmarks)
    np.testing.assert_array_equal(lo, mine["lm_obs"])


def test_drift_correction_matches_the_jax_package(tmp_path):
    """tests/test_drift_correction.py's problem (14 drifting frames, K=256,
    W=5, the port's frontend on the CPU), solved by both packages: ATE
    within 2e-3 m and cost within 1e-3 of the JAX run, and that test's own
    assertions."""
    from vision_slam_frontend_tpu_torch.frontend import Frontend, FrontendConfig
    from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig, generate_sequence

    rig = SyntheticRig()
    config = FrontendConfig(calib=rig.calib(), max_features=256, frame_life=5, fast_threshold=12.0)
    frontend = Frontend(config, device=CPU)
    frames = list(generate_sequence(num_frames=14, step=0.25, rig=rig, odom_drift=0.02))
    for f in frames:
        frontend.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
        frontend.observe_image(f.left, f.right, f.timestamp)
    path = str(tmp_path / "drift.npz")
    serialize.save_problem(path, frontend.get_slam_problem(), config=config)
    gt = np.stack([f.cam_pos for f in frames[1:]])
    odo = np.stack([n.pose.loc for n in serialize.load_problem(path).nodes])
    ate_odom = metrics.ate_rmse(odo, gt, align=False)
    assert ate_odom > 0.04
    skw = dict(max_iterations=15, huber_delta=4.0, trim_threshold=8.0, odom_t_weight=3.0, odom_r_weight=30.0)
    ext = np.asarray(config.left_cam_to_robot)
    jp = jtracks.build_ba_problem(jser.load_problem(path), left_cam_to_robot=ext)
    with np.load(path) as raw:
        cam = res.CameraParams(fx=raw["calib_K_left"][0, 0], fy=raw["calib_K_left"][1, 1],
                               cx=raw["calib_K_left"][0, 2], cy=raw["calib_K_left"][1, 2],
                               R_cr=ext[:3, :3], t_cr=ext[:3, 3], fx_r=raw["calib_K_right"][0, 0],
                               fy_r=raw["calib_K_right"][1, 1], cx_r=raw["calib_K_right"][0, 2],
                               cy_r=raw["calib_K_right"][1, 2], R_rl=raw["calib_right_extrinsic"][:, :3],
                               t_rl=raw["calib_right_extrinsic"][:, 3])
    jcam = jres.CameraParams(**{f: jnp.asarray(getattr(cam, f).numpy()) for f in jres.CameraParams.__dataclass_fields__})
    jo, ji = jba.optimize(jp, cam=jcam, solver=jba.BASolverConfig(**skw))
    to, ti = ba.optimize(port_problem(jp), cam=cam, solver=ba.BASolverConfig(**skw))
    ate_t = metrics.ate_rmse(to.poses_t.numpy(), gt, align=False)
    ate_j = jmetrics.ate_rmse(np.asarray(jo.poses_t), gt, align=False)
    assert abs(ate_t - ate_j) < 2e-3 and ti["cost"] == pytest.approx(ji["cost"], rel=1e-3)
    assert ate_t < 0.6 * ate_odom


# --- the backend CLI -----------------------------------------------------------

def test_backend_cli_on_cpu_equals_the_jax_cli(frontend_npz, tmp_path, capsys):
    """slam_backend --device cpu against the JAX package's slam_backend on the
    port's synthetic:20 problem: the same keys, shapes and dtypes; poses
    within 1e-3 m, landmarks within 1e-2 m, final cost within 1e-4."""
    from vision_slam_frontend_tpu.cli import slam_backend as jcli
    from vision_slam_frontend_tpu_torch.cli import slam_backend

    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert slam_backend.main(["--input", frontend_npz, "--output", ours, "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert jcli.main(["--input", frontend_npz, "--output", theirs]) == 0
    jprinted = capsys.readouterr().out
    line = [ln for ln in printed.splitlines() if ln.startswith("BA problem")][0]
    assert line.startswith([ln for ln in jprinted.splitlines() if ln.startswith("BA problem")][0])
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        if a[k].dtype.kind in "iub":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["nodes_loc"], b["nodes_loc"], atol=1e-3)
    np.testing.assert_allclose(a["nodes_quat"], b["nodes_quat"], atol=1e-3)
    np.testing.assert_allclose(a["ba_landmarks"], b["ba_landmarks"], atol=1e-2)
    assert a["ba_cost_history"][-1] == pytest.approx(b["ba_cost_history"][-1], rel=1e-4)


def _held_to_the_jax_cli(ours: str, theirs: str, pose_atol: float):
    """The same keys, shapes and dtypes (but the cost history's length, the
    number of LM iterations, which float32 PCG's accept/reject flips change),
    int fields equal, poses within `pose_atol`, finite landmarks."""
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].dtype == b[k].dtype, k
        if k != "ba_cost_history":
            assert a[k].shape == b[k].shape, k
        if a[k].dtype.kind in "iub":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["nodes_loc"], b["nodes_loc"], atol=pose_atol)
    np.testing.assert_allclose(a["nodes_quat"], b["nodes_quat"], atol=pose_atol)
    assert np.isfinite(a["ba_landmarks"]).all()
    return a, b


def test_backend_cli_segments_equals_the_jax_cli(frontend_npz, tmp_path):
    """--schur_solver segments (pre-trim, 4 segments, 2 sweeps, the trimmed
    re-run) against the JAX CLI's on the port's synthetic:20 problem: poses
    within tests/test_segment_ba.py's 2e-3, final cost within its 2%."""
    from vision_slam_frontend_tpu.cli import slam_backend as jcli
    from vision_slam_frontend_tpu_torch.cli import slam_backend

    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    args = ["--input", frontend_npz, "--schur_solver", "segments", "--sweeps", "2"]
    assert slam_backend.main(args + ["--output", ours, "--device", "cpu"]) == 0
    assert jcli.main(args + ["--output", theirs]) == 0
    a, b = _held_to_the_jax_cli(ours, theirs, 2e-3)
    assert a["ba_cost_history"][-1] == pytest.approx(b["ba_cost_history"][-1], rel=2e-2)
    assert a["ba_cost_history"][-1] < 0.1 * a["ba_cost_history"][0]


def test_backend_cli_two_cpu_ranks_equal_the_jax_cli(frontend_npz, tmp_path, capfd):
    """--devices 2 --device cpu: two gloo ranks started by the CLI run the
    observation-sharded PCG (trim rounds included) against the JAX CLI's
    --devices 2 on its CPU mesh: poses within the PCG tolerance (2e-2,
    tests/test_parallel.py's), the final cost within 3e-3 (the two LM paths
    part after a float32 flip; measured 5.5e-4)."""
    from vision_slam_frontend_tpu.cli import slam_backend as jcli
    from vision_slam_frontend_tpu_torch.cli import slam_backend

    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert slam_backend.main(["--input", frontend_npz, "--output", ours, "--device", "cpu", "--devices", "2"]) == 0
    assert "Sharded 1058 observations over 2 devices" in capfd.readouterr().out
    assert jcli.main(["--input", frontend_npz, "--output", theirs, "--devices", "2"]) == 0
    a, b = _held_to_the_jax_cli(ours, theirs, 2e-2)
    assert a["ba_cost_history"][-1] == pytest.approx(b["ba_cost_history"][-1], rel=3e-3)


def test_backend_cli_refuses_what_is_not_ported(frontend_npz, tmp_path, capsys):
    """What the CLI cannot run fails with a message and writes nothing:
    --devices 2 on the GPU with fewer than 2 CUDA devices (never a run on
    fewer devices or on the CPU), a solver checkpoint with --devices, an
    unreadable input (on one process and on two ranks)."""
    from vision_slam_frontend_tpu_torch.cli import slam_backend

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    base = ["--input", frontend_npz, "--output", str(tmp_path / "o.npz")]
    if found < 2:
        assert slam_backend.main(base + ["--devices", "2"]) == 2
        assert f"needs 2 CUDA devices, found {found}" in capsys.readouterr().err
    assert slam_backend.main(base + ["--devices", "2", "--device", "cpu", "--checkpoint", "c.npz"]) == 2
    assert "--checkpoint" in capsys.readouterr().err
    missing = ["--input", str(tmp_path / "missing.npz"), "--output", str(tmp_path / "o.npz"), "--device", "cpu"]
    assert slam_backend.main(missing) == 1
    assert slam_backend.main(missing + ["--devices", "2"]) == 1  # each rank fails; the CLI reports it
    assert not os.path.exists(str(tmp_path / "o.npz"))
