"""Frontend checkpoints of the port: a resumed run reproduces the
uninterrupted one, checkpoints cross between the port and the JAX package
in both directions, and the CLI's --checkpoint_every, --resume,
--interrupt_after and --local_ba drain behave as the JAX package's CLI.

Tolerances are tests/test_checkpoint.py's `_problems_equal` (poses 1e-6,
pixels 1e-4, points 1e-3; node ids, feature counts, factors and match lists
equal), and track ids are equal. Across packages the points follow the
triangulation rule of ROADMAP C instead: the port solves exactly, the JAX
package in float32 up to 1.7e-3 relative off, so a point of one package lies
within the JAX package's own error (plus 1e-4 of its range) of the other's.
"""

import copy
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from test_checkpoint import _problems_equal  # noqa: E402
from test_torch_ops import lstsq_triangulate  # noqa: E402
from vision_slam_frontend_tpu.frontend import Frontend as JaxFrontend  # noqa: E402
from vision_slam_frontend_tpu.frontend import FrontendConfig as JaxConfig  # noqa: E402
from vision_slam_frontend_tpu.io.synthetic import SyntheticRig, generate_sequence  # noqa: E402
from vision_slam_frontend_tpu_torch.cli.slam_frontend import main as cli_main  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend import Frontend, FrontendConfig  # noqa: E402
from vision_slam_frontend_tpu_torch.io.serialize import load_problem  # noqa: E402

NUM_FRAMES = 9
SPLIT = 5  # the checkpoint is written after frame SPLIT - 1
FAMILIES = ["orb", "sift"]


def _kw(family):
    return dict(calib=SyntheticRig().calib(), max_features=192, frame_life=4, fast_threshold=12.0,
                descriptor_family=family)


def _port(family):
    return Frontend(FrontendConfig(**_kw(family)), device="cpu")


def _jax(family):
    return JaxFrontend(JaxConfig(**_kw(family)))


@pytest.fixture(scope="module")
def frames():
    return list(generate_sequence(num_frames=NUM_FRAMES, step=0.25, rig=SyntheticRig()))


def _feed(fe, frames, after=-float("inf")):
    for f in frames:
        if f.timestamp <= after:
            continue
        fe.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
        fe.observe_image(f.left, f.right, f.timestamp)
    return fe


def _points_within_jax_error(a, b, config):
    """Every feature's point of problem `a` within |b - exact| + 1e-4 |exact|
    of problem `b`'s, where `exact` is the exact triangulation of the pixels."""
    for na, nb in zip(a.nodes, b.nodes):
        if not nb.features:
            continue
        pa = np.array([f.point3d for f in na.features], np.float64)
        pb = np.array([f.point3d for f in nb.features], np.float64)
        ul = np.array([f.pixel for f in nb.features], np.float32)
        ur = np.array([f.pixel_right for f in nb.features], np.float32)
        exact = lstsq_triangulate(config.P_left, config.P_right, ul, ur)
        norm = np.linalg.norm(exact, axis=-1)
        assert (np.linalg.norm(pa - pb, axis=-1) <= np.linalg.norm(pb - exact, axis=-1) + 1e-4 * norm).all()


def _same_run(a, b, across=False):
    """`b` is the JAX package's run where `across`."""
    pa, pb = a.get_slam_problem(), b.get_slam_problem()
    if across:
        _points_within_jax_error(pa, pb, b.config)
        pa, pb = copy.deepcopy(pa), copy.deepcopy(pb)
        for p in (pa, pb):  # the points are held above
            for n in p.nodes:
                for f in n.features:
                    f.point3d = np.zeros(3, np.float32)
    _problems_equal(pa, pb)
    assert len(a.node_track_ids) == len(b.node_track_ids)
    for ta, tb in zip(a.node_track_ids, b.node_track_ids):
        np.testing.assert_array_equal(ta, tb)


@pytest.fixture(scope="module", params=FAMILIES)
def runs(request, frames, tmp_path_factory):
    """Per family: the port's and the JAX package's uninterrupted runs, and
    each package's checkpoint after frame SPLIT - 1."""
    family = request.param
    tmp = tmp_path_factory.mktemp(family)
    ckpt = {"port": str(tmp / "port.ckpt.npz"), "jax": str(tmp / "jax.ckpt.npz")}
    _feed(_port(family), frames[:SPLIT]).save_checkpoint(ckpt["port"])
    _feed(_jax(family), frames[:SPLIT]).save_checkpoint(ckpt["jax"])
    return family, {"port": _feed(_port(family), frames), "jax": _feed(_jax(family), frames)}, ckpt


def test_resume_reproduces_full_run(runs, frames):
    family, full, ckpt = runs
    resumed = _port(family)
    resume_t = resumed.load_checkpoint(ckpt["port"])
    assert resumed.get_num_poses() == SPLIT - 1
    _same_run(full["port"], _feed(resumed, frames, after=resume_t))
    assert not os.path.exists(ckpt["port"] + ".tmp")


def test_port_resumes_a_jax_checkpoint(runs, frames):
    family, full, ckpt = runs
    resumed = _port(family)
    resume_t = resumed.load_checkpoint(ckpt["jax"])
    _same_run(_feed(resumed, frames, after=resume_t), full["jax"], across=True)


def test_jax_package_resumes_a_port_checkpoint(runs, frames):
    """The port's checkpoint has the JAX package's keys and dtypes (packed
    words as uint32, float descriptors as float32), and the JAX frontend
    resumes it to its own uninterrupted run."""
    family, full, ckpt = runs
    ours, theirs = np.load(ckpt["port"]), np.load(ckpt["jax"])
    assert sorted(ours.files) == sorted(theirs.files)
    for k in theirs.files:
        assert ours[k].dtype == theirs[k].dtype and ours[k].shape == theirs[k].shape, k
    assert ours["ckpt_window_desc"].dtype == (np.float32 if family == "sift" else np.uint32)
    assert ours["ckpt_curr_frame_id"].dtype == np.int64
    resumed = _jax(family)
    resume_t = resumed.load_checkpoint(ckpt["port"])
    _same_run(_feed(resumed, frames, after=resume_t), full["jax"], across=True)


def test_load_checkpoint_zero_fills_old_window_fields_and_checks_the_family(runs, frames, tmp_path):
    family, full, ckpt = runs
    data = dict(np.load(ckpt["port"]))
    for k in ("ckpt_window_points3d", "ckpt_window_pose_t", "ckpt_window_pose_q"):
        del data[k]
    old = str(tmp_path / "old.npz")
    np.savez(old, **data)
    fe = _port(family)
    fe.load_checkpoint(old)
    assert not fe._state.points3d.any() and not fe._state.pose_t.any()
    np.testing.assert_array_equal(fe._state.pose_q.numpy(), np.tile([1.0, 0, 0, 0], (4, 1)))
    other = _port("sift" if family == "orb" else "orb")
    with pytest.raises(ValueError, match="window descriptors"):
        other.load_checkpoint(ckpt["port"])


# --- the CLI -------------------------------------------------------------------

CLI = ["--max_features", "192", "--frame_life", "4", "--device", "cpu"]


def test_cli_checkpoint_and_resume(tmp_path, capsys):
    out = str(tmp_path / "p.npz")
    assert cli_main(["--input", "synthetic:8", "--output", out, "--checkpoint_every", "2", "-v", "1", *CLI]) == 0
    ckpt = out + ".ckpt.npz"
    assert os.path.exists(ckpt) and "[checkpoint] 6 poses" in capsys.readouterr().out
    out2 = str(tmp_path / "p2.npz")
    assert cli_main(["--input", "synthetic:8", "--output", out2, "--resume", ckpt, *CLI]) == 0
    assert "Resumed from" in capsys.readouterr().out
    # The checkpoint came after the last keyframe: the same problem.
    _problems_equal(load_problem(out), load_problem(out2))


def test_cli_sigint_graceful(tmp_path, capsys):
    """--interrupt_after raises a real SIGINT through the handler: exit 130
    with the partial problem and a checkpoint; resuming finishes the run."""
    out = str(tmp_path / "p.npz")
    assert cli_main(["--input", "synthetic:12", "--output", out, "--interrupt_after", "6", *CLI]) == 130
    assert os.path.exists(out) and os.path.exists(out + ".ckpt.npz")
    assert 4 <= len(load_problem(out).nodes) <= 7
    text = capsys.readouterr().out
    assert "SIGINT" in text and "checkpoint" in text
    out2 = str(tmp_path / "p2.npz")
    assert cli_main(["--input", "synthetic:12", "--output", out2, "--resume", out + ".ckpt.npz", *CLI]) == 0
    # 12 frames, the first only seeds the odometry gate: 11 keyframes.
    assert len(load_problem(out2).nodes) == 11
    full = str(tmp_path / "full.npz")
    assert cli_main(["--input", "synthetic:12", "--output", full, *CLI]) == 0
    _problems_equal(load_problem(full), load_problem(out2))


def test_cli_checkpoint_drains_local_ba(tmp_path):
    """With --local_ba the checkpoint holds the poses after the in-flight
    solve is applied: the last checkpoint (at the last keyframe) equals the
    run's output, whose epilogue applies every solve."""
    out = str(tmp_path / "p.npz")
    plain = str(tmp_path / "plain.npz")
    argv = ["--input", "synthetic:10", *CLI]
    assert cli_main([*argv, "--output", out, "--local_ba", "4", "--checkpoint_every", "3"]) == 0
    assert cli_main([*argv, "--output", plain]) == 0
    ckpt, final, odom = np.load(out + ".ckpt.npz"), np.load(out), np.load(plain)
    assert len(final["nodes_id"]) == 9 and int(ckpt["ckpt_curr_frame_id"]) == 9
    np.testing.assert_array_equal(ckpt["nodes_loc"], final["nodes_loc"])
    np.testing.assert_array_equal(ckpt["nodes_quat"], final["nodes_quat"])
    # ... and the solves moved the newest poses off the odometry.
    assert np.abs(ckpt["nodes_loc"][-2] - odom["nodes_loc"][-2]).max() > 1e-5
