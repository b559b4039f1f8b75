"""The port's multi-session merge and its slam_merge CLI against the JAX
package's, on the CPU.

Mirrors tests/test_merge_localba.py's TestMerge and tests/test_merge_cli.py
on two overlapping sessions of the synthetic world (frames 0-8 and 6-13,
K=192, W=4), run through the port's Frontend on the CPU and saved as npz,
which both packages read through their load_problem. Merging is numpy in
both packages: every array and count is compared exactly; the joint BA's
output to the tolerances of tests/test_torch_backend_cli.py's CLI test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vision_slam_frontend_tpu.backend import merge as jmerge  # noqa: E402
from vision_slam_frontend_tpu.backend import tracks as jtracks  # noqa: E402
from vision_slam_frontend_tpu.io import serialize as jser  # noqa: E402
from vision_slam_frontend_tpu.io.kitti import _rotmat_to_quat  # noqa: E402
from vision_slam_frontend_tpu_torch.backend import merge  # noqa: E402
from vision_slam_frontend_tpu_torch.backend import tracks  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend import Frontend, FrontendConfig  # noqa: E402
from vision_slam_frontend_tpu_torch.io import serialize  # noqa: E402
from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig, generate_sequence  # noqa: E402
from vision_slam_frontend_tpu_torch.types.slam_types import BAProblem  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """Two overlapping sessions (the reference tests' frames[:9] and
    frames[6:]), as npz paths, with the config, the frames and session B's
    true alignment (t, q)."""
    rig = SyntheticRig()
    config = FrontendConfig(calib=rig.calib(), max_features=192, frame_life=4, fast_threshold=12.0)
    frames = list(generate_sequence(num_frames=14, step=0.25, rig=rig))
    tmp = tmp_path_factory.mktemp("merge")
    paths = []
    for name, sub in (("a", frames[:9]), ("b", frames[6:])):
        fe = Frontend(config, device=CPU)
        for f in sub:
            fe.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
            fe.observe_image(f.left, f.right, f.timestamp)
        paths.append(str(tmp / f"{name}.npz"))
        serialize.save_problem(paths[-1], fe.get_slam_problem(), config=config)
    fb = frames[6]
    return config, frames, paths, (np.asarray(fb.cam_pos, np.float64), _rotmat_to_quat(fb.cam_to_world_R))


def _both(paths):
    return [serialize.load_problem(p) for p in paths], [jser.load_problem(p) for p in paths]


def _assert_problems_equal(ours, theirs):
    assert [n.node_idx for n in ours.nodes] == [n.node_idx for n in theirs.nodes]
    for a, b in zip(ours.nodes, theirs.nodes):
        np.testing.assert_array_equal(a.pose.loc, b.pose.loc)
        np.testing.assert_array_equal(a.pose.angle, b.pose.angle)
        assert a.timestamp == b.timestamp and len(a.features) == len(b.features)
    assert [(f.pose_idx_initial, f.pose_idx_current, [(m.feature_idx_initial, m.feature_idx_current)
                                                        for m in f.feature_matches]) for f in ours.vision_factors] == \
        [(f.pose_idx_initial, f.pose_idx_current, [(m.feature_idx_initial, m.feature_idx_current)
                                                   for m in f.feature_matches]) for f in theirs.vision_factors]
    assert [(f.pose_i, f.pose_j) for f in ours.odometry_factors] == [(f.pose_i, f.pose_j) for f in theirs.odometry_factors]
    for a, b in zip(ours.odometry_factors, theirs.odometry_factors):
        np.testing.assert_array_equal(a.translation, b.translation)
        np.testing.assert_array_equal(a.rotation, b.rotation)


def _assert_ba_equal(ours, theirs):
    """Every array of the port's BAProblem equals the JAX package's (its
    numpy or jnp arrays), dtype and shape included."""
    mine = ours.to_numpy()
    for f in theirs.__dataclass_fields__:
        v = getattr(theirs, f)
        if v is None:
            assert f not in mine, f
            continue
        v = np.asarray(v)
        assert mine[f].dtype == v.dtype and mine[f].shape == v.shape, f
        np.testing.assert_array_equal(mine[f], v, err_msg=f)


def test_transform_problem_equals_the_jax_packages(sessions):
    config, frames, paths, _ = sessions
    (pa, _), (ja, _) = _both(paths)
    t = np.array([1.0, -2.0, 3.0])
    q = np.array([np.cos(0.3), 0.0, np.sin(0.3), 0.0])
    moved = merge.transform_problem(pa, t, q)
    _assert_problems_equal(moved, jmerge.transform_problem(ja, t, q))
    assert not np.allclose(moved.nodes[0].pose.loc, pa.nodes[0].pose.loc)  # the input is untouched


@pytest.mark.parametrize("aligned", [False, True])
def test_merge_slam_problems_equals_the_jax_packages(sessions, aligned):
    config, frames, paths, (t_b, q_b) = sessions
    ours, theirs = _both(paths)
    tf = [(np.zeros(3), np.array([1.0, 0, 0, 0])), (t_b, q_b)] if aligned else None
    merged, sop = merge.merge_slam_problems(ours, tf)
    j_merged, j_sop = jmerge.merge_slam_problems(theirs, tf)
    _assert_problems_equal(merged, j_merged)
    np.testing.assert_array_equal(sop, j_sop)
    assert sop.tolist() == [0] * len(ours[0].nodes) + [1] * len(ours[1].nodes)


def test_associate_landmarks_equals_the_jax_packages(sessions):
    """The voxel-hash association on the aligned merge: the same merged
    pairs, landmark capacity (a multiple of 128), remapped observations and
    gather tables."""
    config, frames, paths, (t_b, q_b) = sessions
    ours, theirs = _both(paths)
    tf = [(np.zeros(3), np.array([1.0, 0, 0, 0])), (t_b, q_b)]
    merged, sop = merge.merge_slam_problems(ours, tf)
    j_merged, j_sop = jmerge.merge_slam_problems(theirs, tf)
    ext = config.left_cam_to_robot
    arrays = tracks.build_ba_arrays(merged, left_cam_to_robot=ext, gather_tables=False)
    ba_j = jtracks.build_ba_problem(j_merged, left_cam_to_robot=ext)
    got, pairs = merge.associate_landmarks(arrays, sop, radius=0.25)
    want, j_pairs = jmerge.associate_landmarks(ba_j, j_sop, radius=0.25)
    assert pairs == j_pairs and pairs > 20
    assert got["landmarks"].shape[0] % 128 == 0
    _assert_ba_equal(BAProblem.from_numpy(got), want)


@pytest.mark.parametrize("freeze_anchor", [True, False])
def test_merge_sessions_equals_the_jax_packages(sessions, freeze_anchor):
    config, frames, paths, (t_b, q_b) = sessions
    ours, theirs = _both(paths)
    kw = dict(transforms=[(np.zeros(3), np.array([1.0, 0, 0, 0])), (t_b, q_b)],
              left_cam_to_robot=config.left_cam_to_robot, assoc_radius=0.25, freeze_anchor=freeze_anchor)
    ba_t, info = merge.merge_sessions(ours, device=CPU, **kw)
    ba_j, j_info = jmerge.merge_sessions(theirs, **kw)
    _assert_ba_equal(ba_t, ba_j)
    assert info.keys() == j_info.keys()
    for k in info:
        np.testing.assert_array_equal(info[k], j_info[k], err_msg=k)
    if freeze_anchor:
        assert int(ba_t.pose_fixed.sum()) == len(ours[0].nodes)


def _transforms_arg(t_b, q_b) -> str:
    return "0,0,0,1,0,0,0;" + ",".join(str(v) for v in [*t_b, *q_b])


def test_slam_merge_cli_on_cpu_equals_the_jax_cli(sessions, tmp_path, capsys):
    """slam_merge --device cpu against the JAX package's slam_merge on the
    same two npz files: the same keys, shapes and dtypes, integer arrays
    equal, poses within 1e-3 m and landmarks within 1e-2 m; the anchor
    session's poses unchanged and session B's near the ground truth, as
    tests/test_merge_localba.py asserts."""
    from vision_slam_frontend_tpu.backend import metrics as jmetrics
    from vision_slam_frontend_tpu.cli import slam_merge as jcli
    from vision_slam_frontend_tpu_torch.cli import slam_merge

    config, frames, paths, (t_b, q_b) = sessions
    argv = ["--inputs", *paths, "--transforms", _transforms_arg(t_b, q_b), "--assoc_radius", "0.25",
            "--max_iterations", "5"]
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    assert slam_merge.main([*argv, "--output", ours, "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert jcli.main([*argv, "--output", theirs]) == 0
    jprinted = capsys.readouterr().out
    merged_line = [ln for ln in printed.splitlines() if ln.startswith("Merged")]
    assert merged_line == [ln for ln in jprinted.splitlines() if ln.startswith("Merged")] and "Joint BA" in printed
    a, b = np.load(ours), np.load(theirs)
    assert sorted(a.files) == sorted(b.files)
    for k in b.files:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        if a[k].dtype.kind in "iub":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(a["nodes_loc"], b["nodes_loc"], atol=1e-3)
    np.testing.assert_allclose(a["nodes_quat"], b["nodes_quat"], atol=1e-3)
    np.testing.assert_allclose(a["ba_landmarks"], b["ba_landmarks"], atol=1e-2)
    n_a = len(serialize.load_problem(paths[0]).nodes)
    assert a["session_of_pose"].tolist() == [0] * n_a + [1] * (len(a["nodes_id"]) - n_a)
    aligned, _ = merge.merge_slam_problems(
        [serialize.load_problem(p) for p in paths], [(np.zeros(3), np.array([1.0, 0, 0, 0])), (t_b, q_b)])
    np.testing.assert_allclose(a["nodes_loc"][:n_a], np.stack([n.pose.loc for n in aligned.nodes[:n_a]]), atol=1e-6)
    gt_b = np.stack([f.cam_pos for f in frames[7:]])
    assert jmetrics.ate_rmse(a["nodes_loc"][n_a:][: len(gt_b)], gt_b, align=False) < 0.1


def test_slam_merge_cli_refusals(sessions, tmp_path):
    """One input is refused (exit 1, as the JAX CLI does), and so is a
    missing one; nothing is written."""
    from vision_slam_frontend_tpu_torch.cli import slam_merge

    out = str(tmp_path / "o.npz")
    assert slam_merge.main(["--inputs", "only.npz", "--output", out, "--device", "cpu"]) == 1
    paths = sessions[2]
    assert slam_merge.main(["--inputs", str(tmp_path / "missing.npz"), paths[0], "--output", out,
                            "--device", "cpu"]) == 1
    assert not (tmp_path / "o.npz").exists()
