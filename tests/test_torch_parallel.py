"""The port's distributed BA (vision_slam_frontend_tpu_torch/parallel/) on 8
in-process shards against its single-device solve and against the JAX
package's on its 8-device CPU mesh (tests/conftest.py), on the CPU: the
shard layouts, the observation-sharded PCG, the landmark-sharded dense solve,
the efficiency model and the collective counts. The fixtures are
tests/test_parallel.py's. Helpers: tests/test_torch_backend.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from tests.test_backend import synthetic_ba  # noqa: E402
from tests.test_torch_backend import CPU, port_cam, port_problem  # noqa: E402
from vision_slam_frontend_tpu.backend import ba as jba  # noqa: E402
from vision_slam_frontend_tpu.parallel import comm_report as jcomm  # noqa: E402
from vision_slam_frontend_tpu.parallel import make_mesh as jax_mesh  # noqa: E402
from vision_slam_frontend_tpu.parallel import sharded_ba as jsh  # noqa: E402
from vision_slam_frontend_tpu_torch.backend import ba  # noqa: E402
from vision_slam_frontend_tpu_torch.backend.metrics import ate_rmse  # noqa: E402
from vision_slam_frontend_tpu_torch.parallel import comm_report  # noqa: E402
from vision_slam_frontend_tpu_torch.parallel import make_mesh  # noqa: E402
from vision_slam_frontend_tpu_torch.parallel import sharded_ba as sh  # noqa: E402


def _jax_padded(jp, n=8):
    """tests/test_parallel.py's padding of the observations to the mesh."""
    pad = (-jp.obs_pixel.shape[0]) % n
    return jp.replace(
        obs_pose=jnp.pad(jp.obs_pose, (0, pad)), obs_landmark=jnp.pad(jp.obs_landmark, (0, pad)),
        obs_pixel=jnp.pad(jp.obs_pixel, ((0, pad), (0, 0))), obs_mask=jnp.pad(jp.obs_mask, (0, pad)),
    ) if pad else jp


def test_observation_shard_layout():
    """shard_ba_problem on 8 in-process shards keeps every observation row
    (the shards split them evenly), the stereo fields and pose_fixed, drops
    the gather tables; a shard's partial sum is the sum of its own rows."""
    jcam, jp, _, _ = synthetic_ba(seed=14)
    p = sh.pad_observations(port_problem(jp), 8)
    P = p.num_poses
    p = p.replace(obs_pixel_right=p.obs_pixel + torch.tensor([5.0, 0.0]), obs_right_mask=p.obs_mask,
                  pose_fixed=torch.arange(P) == 1)
    mesh = make_mesh(8, CPU)
    sharded = sh.shard_ba_problem(p, mesh)
    assert sharded.num_observations == p.num_observations and sharded.num_observations % 8 == 0
    assert sharded.pose_obs is None and sharded.lm_obs is None
    assert sharded.obs_pixel_right is not None and sharded.obs_right_mask is not None
    assert torch.equal(sharded.pose_fixed, p.pose_fixed)
    data = torch.randn(p.num_observations, 3)
    part = mesh.segsum(data, sharded.obs_pose, P)
    Ns = p.num_observations // 8
    assert part.shape == (8, P, 3)
    for k in range(8):
        rows = slice(k * Ns, (k + 1) * Ns)
        ref = torch.zeros(P, 3).index_add_(0, sharded.obs_pose[rows], data[rows])
        torch.testing.assert_close(part[k], ref, rtol=0, atol=0)
    opt, _ = sh.optimize_sharded(p, mesh, cam=port_cam(jcam), solver=ba.BASolverConfig(max_iterations=2))
    assert torch.equal(opt.poses_t[1], p.poses_t[1])  # the fixed pose stays


def test_indivisible_observation_capacity_is_rejected():
    _, jp, _, _ = synthetic_ba(seed=13)
    p = sh.pad_observations(port_problem(jp), 8)
    p = p.replace(**{f: torch.cat([getattr(p, f), getattr(p, f)[:1]]) for f in ("obs_pose", "obs_landmark",
                                                                               "obs_pixel", "obs_mask")})
    with pytest.raises(ValueError, match="not divisible"):
        sh.shard_ba_problem(p, make_mesh(8, CPU))


def test_build_lm_sharded_equals_the_jax_packages():
    """Every table equal, dtype and all; tests/test_parallel.py's partition
    checks; an indivisible landmark capacity is rejected."""
    _, jp, _, _ = synthetic_ba(seed=21)
    theirs = jsh.build_lm_sharded(jp, 8)
    ours = sh.build_lm_sharded(port_problem(jp), 8)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    assert int(ours["msk"].sum()) == int(np.asarray(jp.obs_mask).sum())
    bad = port_problem(jp)
    bad = bad.replace(landmarks=bad.landmarks[:-3], landmark_mask=bad.landmark_mask[:-3])
    with pytest.raises(ValueError, match="not divisible"):
        sh.build_lm_sharded(bad, 8)


@pytest.fixture(scope="module")
def mesh8():
    return jax_mesh(8)


def test_landmark_sharded_dense_matches_one_device_and_the_reference(mesh8):
    """tests/test_parallel.py::test_sharded_dense_matches_single_device's
    problem and checks, on 8 in-process shards: against the port's
    single-device dense solve (poses within 1e-4) and the JAX package's
    landmark-sharded solve on its 8-device mesh (poses within 2e-2, that
    test's tolerance, and ATE within 5e-3); 3 collectives per LM iteration."""
    jcam, jp, gt_t, _ = synthetic_ba(pose_noise=0.05, lm_noise=0.2, px_noise=0.3, seed=22)
    cam, p = port_cam(jcam), port_problem(jp)
    solver = ba.BASolverConfig(max_iterations=8, schur_solver="dense")
    single, _ = ba.optimize(p, cam=cam, solver=solver)
    mesh = make_mesh(8, CPU)
    ours, info = sh.optimize_sharded_dense(p, mesh, cam=cam, solver=solver)
    theirs, _ = jsh.optimize_sharded_dense(jp, mesh8, cam=jcam, solver=jba.BASolverConfig(max_iterations=8,
                                                                                         schur_solver="dense"))
    np.testing.assert_allclose(ours.poses_t.numpy(), single.poses_t.numpy(), atol=1e-4)
    np.testing.assert_allclose(ours.poses_t.numpy(), np.asarray(theirs.poses_t), atol=2e-2)
    ate = ate_rmse(ours.poses_t.numpy(), gt_t, align=False)
    assert abs(ate - ate_rmse(np.asarray(theirs.poses_t), gt_t, align=False)) < 5e-3 and ate < 0.02
    assert mesh.calls == 3 * info["iterations"]


def test_observation_sharded_pcg_matches_one_device_and_the_reference(mesh8):
    """tests/test_parallel.py::test_sharded_matches_single_device's problem
    (8 LM iterations) on 8 in-process shards: the final cost within 3e-4 of
    the port's single-device scatter PCG and of the JAX package's
    observation-sharded run on its 8-device mesh (float32 PCG at small damping
    flips LM decisions on a reduction order: ROADMAP "Settled"); poses within
    that test's 2e-2, ATE within 5e-3."""
    jcam, jp, gt_t, _ = synthetic_ba(pose_noise=0.05, lm_noise=0.2, px_noise=0.3, seed=12)
    jp = _jax_padded(jp)
    cam, p = port_cam(jcam), port_problem(jp)
    solver = ba.BASolverConfig(max_iterations=8)
    single, info_1 = ba.optimize(p.replace(pose_obs=None, pose_obs_mask=None, lm_obs=None, lm_obs_mask=None),
                                 cam=cam, solver=solver)
    ours, info = sh.optimize_sharded(p, make_mesh(8, CPU), cam=cam, solver=solver)
    theirs, info_j = jsh.optimize_sharded(jp, mesh8, cam=jcam, solver=jba.BASolverConfig(max_iterations=8))
    assert info["cost"] == pytest.approx(info_1["cost"], rel=3e-4)
    assert info["cost"] == pytest.approx(info_j["cost"], rel=3e-4)
    np.testing.assert_allclose(ours.poses_t.numpy(), single.poses_t.numpy(), atol=2e-2)
    np.testing.assert_allclose(ours.poses_t.numpy(), np.asarray(theirs.poses_t), atol=2e-2)
    ate = ate_rmse(ours.poses_t.numpy(), gt_t, align=False)
    assert abs(ate - ate_rmse(np.asarray(theirs.poses_t), gt_t, align=False)) < 5e-3 and ate < 0.02


@pytest.mark.parametrize("n", [2, 4, 8])
def test_predict_efficiency_equals_the_jax_packages(n):
    for args in ((0.3, 4_079_616, 67, n, 10e9, 25e-6), (0.05, 1e6, 3, n, 450e9, 2e-6), (0.3, 4e6, 67, n, 10e9, 0.0)):
        assert comm_report.predict_efficiency(*args) == jcomm.predict_efficiency(*args)


def test_report_modes_counts_equal_the_analytic_counts():
    """One LM iteration of each mode on 8 in-process shards (the JAX
    package's test shape, P=16, L=1024): the group's counted collective
    calls and bytes equal expected_counts."""
    results = {r["mode"]: r for r in comm_report.report_modes(n_devices=8, P=16, L=1024, obs=4, device=CPU,
                                                              cg_iters=8)}
    assert sorted(results) == ["lm_sharded_dense", "obs_sharded_pcg", "segment_parallel"]
    for r in results.values():
        assert (r["calls"], r["bytes"]) == (r["expected_calls"], r["expected_bytes"]), r
    assert results["obs_sharded_pcg"]["calls"] == 4 + 2 * 8
    assert results["lm_sharded_dense"]["bytes"] >= (6 * 16) ** 2 * 4  # the reduced camera matrix dominates
