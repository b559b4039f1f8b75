"""The port's Frontend and CLI against the JAX package's, free-running on the
synthetic sequence, and the port's independence from JAX.

Whole slice, 8 frames at the default size: keyframe and odometry-factor
counts equal; per-node feature counts and the total of vision matches within
1%; at least 99% of track ids equal; the port's npz has the reference's
keys, shapes and dtypes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vision_slam_frontend_tpu.frontend import Frontend as JaxFrontend  # noqa: E402
from vision_slam_frontend_tpu.frontend import FrontendConfig as JaxConfig  # noqa: E402
from vision_slam_frontend_tpu.io.serialize import save_problem as jax_save_problem  # noqa: E402
from vision_slam_frontend_tpu.io.synthetic import SyntheticRig, generate_sequence  # noqa: E402
from vision_slam_frontend_tpu_torch.cli import slam_frontend as cli  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend import Frontend, FrontendConfig  # noqa: E402
from vision_slam_frontend_tpu_torch.io.serialize import save_problem  # noqa: E402

NUM_FRAMES = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(frontend, frames):
    added = []
    for f in frames:
        frontend.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
        added.append(frontend.observe_image(f.left, f.right, f.timestamp))
    return added


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    """Both frontends over the same frames; both problems saved as npz."""
    frames = list(generate_sequence(num_frames=NUM_FRAMES, rig=SyntheticRig()))
    calib = SyntheticRig().calib()
    ref = JaxFrontend(JaxConfig(calib=calib, fast_threshold=12.0))
    port = Frontend(FrontendConfig(calib=calib, fast_threshold=12.0), device="cpu")
    added_ref, added_port = _run(ref, frames), _run(port, frames)
    tmp = tmp_path_factory.mktemp("slice")
    paths = str(tmp / "ref.npz"), str(tmp / "port.npz")
    jax_save_problem(paths[0], ref.get_slam_problem(), config=ref.config, node_track_ids=ref.node_track_ids)
    save_problem(paths[1], port.get_slam_problem(), config=port.config, node_track_ids=port.node_track_ids)
    return ref, port, (added_ref, added_port), paths


def test_slice_counts(slice_run):
    ref, port, (added_ref, added_port), _ = slice_run
    assert added_port == added_ref and sum(added_port) == NUM_FRAMES - 1
    p_ref, p_port = ref.get_slam_problem(), port.get_slam_problem()
    assert len(p_port.nodes) == len(p_ref.nodes) == port.get_num_poses()
    assert len(p_port.odometry_factors) == len(p_ref.odometry_factors)
    assert len(p_port.vision_factors) == len(p_ref.vision_factors)
    assert p_port.summary() == p_ref.summary()
    for a, b in zip(p_port.nodes, p_ref.nodes):
        assert abs(len(a.features) - len(b.features)) <= 0.01 * len(b.features)
        np.testing.assert_allclose(a.pose.loc, b.pose.loc, atol=1e-6)
        np.testing.assert_allclose(a.pose.angle, b.pose.angle, atol=1e-6)
    m_ref = sum(len(v.feature_matches) for v in p_ref.vision_factors)
    m_port = sum(len(v.feature_matches) for v in p_port.vision_factors)
    assert m_ref > 100 and abs(m_port - m_ref) <= 0.01 * m_ref
    for a, b in zip(p_port.odometry_factors, p_ref.odometry_factors):
        assert (a.pose_i, a.pose_j) == (b.pose_i, b.pose_j)
        np.testing.assert_allclose(a.translation, b.translation, atol=1e-6)


def test_slice_track_ids_and_stats(slice_run):
    ref, port, _, _ = slice_run
    t_ref = np.concatenate(ref.node_track_ids)
    t_port = np.concatenate(port.node_track_ids)
    assert t_port.shape == t_ref.shape
    assert (t_port == t_ref).mean() >= 0.99
    s_ref, s_port = ref.stats_summary(), port.stats_summary()
    assert s_port["keyframes"] == s_ref["keyframes"]
    assert s_port["features_min"] == s_ref["features_min"]
    assert [s["window_matches"] for s in port.stats] == [s["window_matches"] for s in ref.stats]


def test_slice_npz_layout(slice_run):
    _, _, _, (ref_path, port_path) = slice_run
    with np.load(ref_path) as r, np.load(port_path) as p:
        assert sorted(p.files) == sorted(r.files)
        for k in r.files:
            assert (p[k].shape, p[k].dtype) == (r[k].shape, r[k].dtype), k
        for k in ("nodes_id", "feat_node", "feat_idx", "vf_pose_initial", "vf_pose_current", "of_pose_i"):
            np.testing.assert_array_equal(p[k], r[k])
        for k in ("calib_K_left", "calib_P_left", "calib_P_right", "calib_dist_left"):
            np.testing.assert_array_equal(p[k], r[k])


def test_odometry_gate_and_update_poses():
    frames = list(generate_sequence(num_frames=3, rig=SyntheticRig()))
    fe = Frontend(FrontendConfig(calib=SyntheticRig().calib(), fast_threshold=12.0, max_features=128),
                  device="cpu")
    assert not fe.observe_image(frames[0].left, frames[0].right, 0.0)  # no odometry yet
    assert _run(fe, frames) == [False, True, True]
    assert fe.get_num_poses() == 2
    new_t = np.arange(6, dtype=np.float32).reshape(2, 3)
    new_q = np.tile(np.array([1, 0, 0, 0], np.float32), (2, 1))
    assert fe.update_poses(new_t, new_q) == 2
    np.testing.assert_array_equal(fe.get_slam_problem().nodes[1].pose.loc, new_t[1])
    with pytest.raises(ValueError, match="do not match"):
        fe.update_poses(new_t[:1], new_q[:1])
    node = fe.get_slam_problem().nodes[0]
    node.pose.loc = np.ones(3, np.float32)
    assert fe.update_poses([node]) == 1


def test_cli_synthetic_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "p.npz")
    assert cli.main(["--input", "synthetic:3", "--output", out, "--device", "cpu", "--max_features", "128"]) == 0
    printed = capsys.readouterr().out
    assert "Saved SLAM problem with 2 nodes, 1 odometry factors" in printed
    assert "[perf] 3 stereo frames, 2 keyframes" in printed
    with np.load(out) as data:
        assert len(data["nodes_id"]) == 2


def test_cli_refuses_inputs_and_devices_it_cannot_serve(tmp_path):
    with pytest.raises(ValueError, match="Cannot auto-detect dataset type"):
        cli.main(["--input", "run.txt", "--output", str(tmp_path / "p.npz"), "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        cli.main(["--input", "synthetic:3", "--output", str(tmp_path / "p.npz")])  # default --device cuda


def test_port_runs_without_jax(tmp_path):
    """Importing the port and running its CLI on the CPU loads no JAX."""
    out = str(tmp_path / "p.npz")
    code = (
        "import sys\n"
        "import vision_slam_frontend_tpu_torch\n"
        "from vision_slam_frontend_tpu_torch.cli import slam_frontend\n"
        f"rc = slam_frontend.main(['--input', 'synthetic:3', '--output', {out!r}, '--device', 'cpu'])\n"
        "loaded = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert rc == 0 and not loaded, loaded\n"
        "print('NO_JAX_OK')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout


def test_chip_smoke_fails_without_a_gpu():
    """The GPU smoke test exits non-zero and prints no result line where
    there is no CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "no CUDA device" in proc.stderr
