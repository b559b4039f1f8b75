"""The port's bundle-adjustment backend against the JAX package's, on the CPU.

The same numpy inputs go through `vision_slam_frontend_tpu.backend` and
`vision_slam_frontend_tpu_torch.backend`; BAProblem.from_numpy / to_numpy
carry the problems across. Integer outputs (gather tables, track ids, masks)
are compared exactly, floats to the tolerance stated at each comparison.
The port computes in float32 as the JAX package does; its Jacobians are
closed forms of the derivatives JAX takes with jax.jacfwd, and its dense
coupling term is float32 where the JAX package's is a compensated bf16
split, so steps differ by what the tests below measure.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from tests.test_backend import synthetic_ba  # noqa: E402
from vision_slam_frontend_tpu.backend import ba as jba  # noqa: E402
from vision_slam_frontend_tpu.backend import metrics as jmetrics  # noqa: E402
from vision_slam_frontend_tpu.backend import residuals as jres  # noqa: E402
from vision_slam_frontend_tpu.geometry import rotation as jrot  # noqa: E402
from vision_slam_frontend_tpu.io.synthetic import synthetic_ba_problem as jax_synthetic_ba  # noqa: E402
from vision_slam_frontend_tpu_torch.backend import ba  # noqa: E402
from vision_slam_frontend_tpu_torch.backend import metrics  # noqa: E402
from vision_slam_frontend_tpu_torch.backend import residuals as res  # noqa: E402
from vision_slam_frontend_tpu_torch.geometry import rotation as rot  # noqa: E402
from vision_slam_frontend_tpu_torch.io import serialize  # noqa: E402
from vision_slam_frontend_tpu_torch.types.slam_types import BAProblem  # noqa: E402

CPU = "cpu"
W = (4.0, 30.0, 60.0)  # Huber delta, odometry weights: BASolverConfig's defaults


def port_problem(jax_problem) -> BAProblem:
    return BAProblem.from_numpy(jax_problem, device=CPU)


def port_cam(jax_cam) -> res.CameraParams:
    return res.CameraParams(**{f: np.asarray(getattr(jax_cam, f)) for f in jax_cam.__dataclass_fields__})


def jax_w():
    return tuple(jnp.float32(x) for x in W)


def close(ours, theirs, rel: float, what: str = ""):
    """|ours - theirs| <= rel * max|theirs| elementwise."""
    ours = ours.detach().numpy() if hasattr(ours, "detach") else np.asarray(ours)
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape, (what, ours.shape, theirs.shape)
    scale = max(float(np.abs(theirs).max()), 1e-12) if theirs.size else 1.0
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=rel * scale, err_msg=what)


# --- rotations -------------------------------------------------------------

def _quats(n=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q[:4] = [[1, 0, 0, 0], [-0.2, 0.1, 0.9, 0.3], [0.999, 1e-5, -2e-5, 0], [1e-9, 0, 1, 0]]
    return q


def _axis_angles(n=64, seed=1):
    rng = np.random.default_rng(seed)
    aa = rng.normal(size=(n, 3)).astype(np.float32)
    aa[:3] = [[0, 0, 0], [1e-5, -2e-5, 3e-6], [3.1, 0, 0.01]]
    return aa


ROTATION_CASES = {
    "quat_normalize": lambda: (_quats(),),
    "quat_multiply": lambda: (_quats(seed=2), _quats(seed=3)),
    "quat_conjugate": lambda: (_quats(),),
    "quat_inverse": lambda: (_quats(),),
    "quat_rotate": lambda: (jrot.quat_normalize(_quats()), np.random.default_rng(4).normal(size=(64, 3)).astype(np.float32)),
    "quat_to_matrix": lambda: (_quats(),),
    "matrix_to_quat": lambda: (np.asarray(jrot.quat_to_matrix(_quats())),),
    "axis_angle_to_quat": lambda: (_axis_angles(),),
    "quat_to_axis_angle": lambda: (_quats(),),
}


@pytest.mark.parametrize("name", sorted(ROTATION_CASES))
def test_rotation_ops_equal_the_jax_packages(name):
    """Each op on the same float32 inputs (identity, tiny and near-pi
    rotations, a near-zero w, unnormalized quaternions): within 2e-6 of the
    largest output."""
    args = [np.asarray(a, np.float32) for a in ROTATION_CASES[name]()]
    theirs = getattr(jrot, name)(*[jnp.asarray(a) for a in args])
    ours = getattr(rot, name)(*[torch.from_numpy(a.copy()) for a in args])
    close(ours, theirs, 2e-6, name)


# --- BAProblem carried across ------------------------------------------------

def test_ba_problem_carries_across():
    cam, jp, _, _ = jax_synthetic_ba(P=12, L=200, stereo=True, seed=2)
    p = port_problem(jp)
    assert p.obs_pose.dtype == torch.int64 and p.lm_obs.dtype == torch.int64
    assert p.obs_mask.dtype == torch.bool and p.poses_t.dtype == torch.float32
    back = p.to_numpy()
    for f in jp.__dataclass_fields__:
        v = getattr(jp, f)
        if v is None:
            assert f not in back
            continue
        assert back[f].dtype == np.asarray(v).dtype, f
        np.testing.assert_array_equal(back[f], np.asarray(v), err_msg=f)
    q = p.replace(landmarks=p.landmarks + 1).to(CPU)
    assert torch.equal(q.landmarks, p.landmarks + 1) and q.num_poses == 12 and q.device.type == "cpu"


# --- residuals and Jacobians ------------------------------------------------

def _linearization_problem(stereo: bool):
    """A noisy synthetic problem with a few landmarks moved behind their
    cameras (the clipped-residual branch) and near the camera plane."""
    cam, jp, _, _ = jax_synthetic_ba(P=16, L=512, stereo=stereo, seed=1, pose_noise=0.3)
    lm = np.asarray(jp.landmarks).copy()
    t = np.asarray(jp.poses_t)
    first = np.asarray(jp.obs_pose)[np.searchsorted(np.asarray(jp.obs_landmark), np.arange(5))]
    lm[:5] = t[first] - [0.0, 0.0, 3.0]  # behind
    lm[5:8] = t[np.asarray(jp.obs_pose)[np.searchsorted(np.asarray(jp.obs_landmark), np.arange(5, 8))]] + [0.3, 0.1, 1e-7]
    return cam, jp.replace(landmarks=jnp.asarray(lm))


@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_reprojection_linearization_equals_the_jax_packages(stereo):
    """Flat and pose-major residuals and Jacobians, Huber weights, and the
    pm inputs: residuals within 1e-6 and Jacobians within 2e-6 of their
    largest entry (float32 rounding; the port's Jacobians are closed forms)."""
    cam, jp = _linearization_problem(stereo)
    tc, p = port_cam(cam), port_problem(jp)
    flat_j = jres.linearize_reprojection(cam, jp.poses_t, jp.poses_q, jp.landmarks, jp.obs_pose, jp.obs_landmark,
                                         jp.obs_pixel, jp.obs_mask, jp.obs_pixel_right, jp.obs_right_mask)
    flat_t = res.linearize_reprojection(tc, p.poses_t, p.poses_q, p.landmarks, p.obs_pose, p.obs_landmark,
                                        p.obs_pixel, p.obs_mask, p.obs_pixel_right, p.obs_right_mask)
    for name, ours, theirs, rel in zip(("r", "J_pose", "J_lm"), flat_t, flat_j, (1e-6, 2e-6, 2e-6)):
        close(ours, theirs, rel, name)
    assert (np.asarray(flat_j[0]) != 0).any(axis=-1).sum() > 1000
    assert torch.equal(res.reprojection_residuals(tc, p.poses_t, p.poses_q, p.landmarks, p.obs_pose,
                                                  p.obs_landmark, p.obs_pixel, p.obs_mask, p.obs_pixel_right,
                                                  p.obs_right_mask), flat_t[0])

    pm_j, pm_t = jba._build_pm_inputs(jp), ba._build_pm_inputs(p)
    for k in ("landmark", "mask") + (("right_mask",) if stereo else ()):
        np.testing.assert_array_equal(pm_t[k].numpy(), np.asarray(pm_j[k]), err_msg=k)
    lin_j = jba._linearize_pm(cam, jp, pm_j, *jax_w(), True)
    lin_t = ba._linearize_pm(tc, p, pm_t, *W, True)
    for name, ours, theirs in zip(("r_pm", "J_pose_pm", "J_lm_pm", "r_odom", "J_i", "J_j"), lin_t, lin_j):
        close(ours, theirs, 2e-6, name)
    close(res.huber_weights(flat_t[0], 4.0), jres.huber_weights(flat_j[0], 4.0), 1e-6, "huber")


def test_odometry_linearization_equals_the_jax_packages():
    """Odometry residuals and Jacobians, with an exactly zero rotation error,
    a tiny one, one past 90 degrees and a non-unit pose quaternion: within
    2e-6 of the largest entry."""
    rng = np.random.default_rng(3)
    Q = 32
    t = rng.normal(size=(Q + 1, 3)).astype(np.float32)
    q = rng.normal(size=(Q + 1, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[5] *= 1.01
    oi, oj = np.arange(Q), np.arange(1, Q + 1)
    q_rel = np.asarray(jrot.quat_multiply(jrot.quat_inverse(q[oi]), q[oj]))
    ot = rng.normal(size=(Q, 3)).astype(np.float32)
    oq = rng.normal(size=(Q, 4)).astype(np.float32)
    oq[0] = q_rel[0]  # zero rotation error
    oq[1] = q_rel[1] + [0, 1e-6, 0, 0]
    mask = np.ones(Q, bool)
    mask[-1] = False
    args = (t, q, oi.astype(np.int32), oj.astype(np.int32), ot, oq, mask)
    theirs = jres.linearize_odometry(*[jnp.asarray(a) for a in args], jnp.float32(30.0), jnp.float32(60.0))
    ours = res.linearize_odometry(*[torch.from_numpy(np.asarray(a, np.int64 if a.dtype == np.int32 else None))
                                    for a in args], 30.0, 60.0)
    for name, a, b in zip(("r", "J_i", "J_j"), ours, theirs):
        close(a, b, 2e-6, name)
    assert np.abs(np.asarray(theirs[0])[0, 3:]).max() < 1e-5


@pytest.mark.parametrize("huber", [True, False], ids=["huber", "quadratic"])
@pytest.mark.parametrize("stereo", [False, True], ids=["mono", "stereo"])
def test_compute_cost_equals_the_jax_packages(stereo, huber):
    cam, jp = _linearization_problem(stereo)
    theirs = float(jba.compute_cost(cam, jp, *jax_w(), huber))
    ours = float(ba.compute_cost(port_cam(cam), port_problem(jp), *W, huber))
    assert ours == pytest.approx(theirs, rel=2e-6)


# --- one Schur step at the same linearization ---------------------------------

# (solver, lambda) -> the largest |port - JAX| allowed, relative to the largest
# entry of d_pose and of d_lm, and the allowed relative difference of the
# residual norm; each about 3 to 5 times what was measured on this problem.
# Dense (the JAX package's coupling is a compensated bf16 split, the port's
# float32), measured: 5.9e-3 / 2.0e-3 / 4.3e-6 at lambda 1e-3, 1.4e-4 /
# 1.3e-4 / 2.3e-4 at 1. PCG (24 CG iterations amplify float32 rounding; its
# residual norm at the end is rounding noise), measured: 6.1e-4 / 5.4e-4 /
# 4.7e-2 at 0.1, 4.0e-5 / 2.1e-5 / 1.7e-2 at 10. (At lambda 1e-3 this mono
# problem's CG differs by 23% between the two: not compared.)
STEP_TOL = {
    ("dense", 1e-3): (2e-2, 1e-2, 1e-4),
    ("dense", 1.0): (1e-3, 1e-3, 1e-3),
    ("pcg", 0.1): (3e-3, 3e-3, 0.15),
    ("pcg", 10.0): (2e-4, 1e-4, 0.1),
}


@pytest.fixture(scope="module")
def step_problem():
    """tests/test_backend.py's dense-vs-PCG problem, linearized by the JAX
    package; both packages' solvers get that same linearization."""
    cam, jp, _, _ = synthetic_ba(P=7, L=90, pose_noise=0.04, lm_noise=0.25, px_noise=0.2, seed=5)
    pm = jba._build_pm_inputs(jp)
    lin = jba._linearize_pm(cam, jp, pm, *jax_w(), True)
    p = port_problem(jp)
    return jp, pm, lin, p, ba._build_pm_inputs(p), tuple(torch.from_numpy(np.array(x)) for x in lin)


@pytest.mark.parametrize("solver, lam", sorted(STEP_TOL), ids=[f"{s}-{lam}" for s, lam in sorted(STEP_TOL)])
def test_schur_step_equals_the_jax_packages(step_problem, solver, lam):
    jp, pm_j, lin_j, p, pm_t, lin_t = step_problem
    if solver == "dense":
        theirs = jba._solve_schur_dense_pm(pm_j, *lin_j, jp, jnp.float32(lam), fix_first=True,
                                           plan=jba._dense_coupling_plan(jp))
        ours = ba._dense_core(pm_t, *lin_t, p, lam, True)
    else:
        theirs = jba._solve_schur_pcg_posemajor_from_pm(pm_j, *lin_j, jp, jnp.float32(lam), cg_iters=24,
                                                        fix_first=True)
        ours = ba._solve_schur_pcg_posemajor_from_pm(pm_t, *lin_t, p, lam, 24, True)
    tol_pose, tol_lm, tol_res = STEP_TOL[solver, lam]
    close(ours[0], theirs[0], tol_pose, "d_pose")
    close(ours[1], theirs[1], tol_lm, "d_lm")
    assert float(ours[2]) == pytest.approx(float(theirs[2]), rel=tol_res)
    assert float(np.abs(np.asarray(theirs[0])[0]).max()) == float(ours[0][0].abs().max()) == 0.0  # the gauge


def test_dense_plateau_floor_copy_is_the_solvers_terms(step_problem):
    """backend/dense_plateau's copy of the Schur terms gives the solver's
    dense step bit for bit at the solver's landmark floor (1e-5) and another
    step with no floor."""
    from unittest import mock

    from vision_slam_frontend_tpu_torch.backend import dense_plateau

    _, _, _, p, pm_t, lin_t = step_problem
    ref = ba._dense_core(pm_t, *lin_t, p, 1e-3, True)
    steps = {}
    for floor in (1e-5, 0.0):
        with mock.patch.object(ba, "_schur_terms", dense_plateau._schur_terms_with_floor(floor)):
            steps[floor] = ba._dense_core(pm_t, *lin_t, p, 1e-3, True)
    assert torch.equal(steps[1e-5][0], ref[0]) and torch.equal(steps[1e-5][1], ref[1])
    assert not torch.equal(steps[0.0][0], ref[0])
    assert set(dense_plateau.FLOORS.values()) == {0.0, 1e-6, 1e-5, 1e-4}


def test_dense_plateau_coupling_is_the_jax_packages_compensated_product(step_problem):
    """backend/dense_plateau's emulated coupling: each pair's 6x6 block from
    bf16 hi/mid/lo parts (hh + mm + hm + mh + hl + lh, float32 sums) equals
    the JAX package's _bbt_compensated on the same Bt within float32 sum-order
    rounding (2e-6 of the largest entry); the dense step through that
    assembly is a finite step of the solver's shape."""
    from unittest import mock

    from vision_slam_frontend_tpu_torch.backend import dense_plateau

    rng = np.random.default_rng(21)
    L, Ml, P = 7, 3, 5
    Bt = (rng.normal(size=(L, Ml, 6, 3)) * 10.0 ** rng.uniform(-3, 4, size=(L, Ml, 6, 3))).astype(np.float32)
    pose_of = np.stack([rng.permutation(P)[:Ml] for _ in range(L)])  # one slot per (landmark, pose)
    oh = pose_of[:, :, None] == np.arange(P)[None, None, :]
    theirs = np.asarray(jba._bbt_compensated(jnp.asarray(Bt), jnp.asarray(oh)))  # (6, P, 6, P)
    ours = np.zeros((6, P, 6, P), np.float64)
    Btt = torch.from_numpy(Bt)
    for a in range(Ml):
        for b in range(Ml):
            C = dense_plateau.compensated_coupling(Btt[:, a], Btt[:, b]).double().numpy()  # (L, 6, 6)
            for l in range(L):
                ours[:, pose_of[l, a], :, pose_of[l, b]] += C[l]
    close(ours, theirs, 2e-6, "coupling")
    _, _, _, p, pm_t, lin_t = step_problem
    with mock.patch.object(ba, "_dense_assemble", dense_plateau._dense_assemble_compensated):
        d_pose, d_lm, _ = ba._dense_core(pm_t, *lin_t, p, 1e-3, True)
    ref = ba._dense_core(pm_t, *lin_t, p, 1e-3, True)
    assert d_pose.shape == ref[0].shape and bool(torch.isfinite(d_pose).all() and torch.isfinite(d_lm).all())
    close(d_pose, ref[0].numpy(), 2e-2, "compensated d_pose")


def test_scatter_pcg_equals_the_jax_packages():
    """Without gather tables: the flat linearization, and the scatter-sum PCG
    step at lambda 1 (24 CG iterations; measured 4.6e-5 / 9.2e-5 of the
    largest d_pose / d_lm entry, held to 3e-4); optimize then runs that
    form for a dense request, as the JAX package does."""
    cam, jp, _, _ = synthetic_ba(P=7, L=90, pose_noise=0.04, lm_noise=0.25, px_noise=0.2, seed=5)
    jp = jp.replace(pose_obs=None, pose_obs_mask=None, lm_obs=None, lm_obs_mask=None)
    p = port_problem(jp)
    assert p.pose_obs is None
    lin_j = jba._linearize(cam, jp, *jax_w(), True)
    lin_t = ba._linearize(port_cam(cam), p, *W, True)
    for a, b in zip(lin_t, lin_j):
        close(a, b, 2e-6)
    theirs = jba._solve_schur_pcg_scatter(*lin_j, jp, jnp.float32(1.0), 24, True)
    ours = ba._solve_schur_pcg_scatter(*[torch.from_numpy(np.array(x)) for x in lin_j], p, 1.0, 24, True)
    close(ours[0], theirs[0], 3e-4, "d_pose")
    close(ours[1], theirs[1], 3e-4, "d_lm")
    solver = ba.BASolverConfig(max_iterations=6, schur_solver="dense")
    assert ba._solver_form(p, solver) == "pcg_scatter"
    _, info = ba.optimize(p, cam=port_cam(cam), solver=solver)
    assert info["cost"] < 0.1 * info["history"][0] and info["accepted"] >= 1


def test_solver_dispatch_is_the_jax_packages():
    """auto: dense up to dense_max_poses (and the chunked-dense window), PCG
    above; the chunked names run the single-program forms."""
    _, jp, _, _ = jax_synthetic_ba(P=12, L=200, seed=2)
    p = port_problem(jp)
    cfg = ba.BASolverConfig
    assert ba._solver_form(p, cfg()) == "dense"
    assert ba._solver_form(p, cfg(dense_max_poses=4, dense_chunked_max_poses=4)) == "pcg"
    assert ba._solver_form(p, cfg(dense_max_poses=4, dense_chunked_max_poses=64)) == "dense"
    assert ba._solver_form(p, cfg(schur_solver="dense_chunked")) == "dense"
    assert ba._solver_form(p, cfg(schur_solver="pcg_chunked")) == "pcg"
    assert ba._solver_form(p, cfg(schur_solver="pcg", chunked_obs_threshold=1)) == "pcg"
    assert dataclass_defaults(ba.BASolverConfig) == dataclass_defaults(jba.BASolverConfig)


def dataclass_defaults(cls):
    import dataclasses

    return {f.name: f.default for f in dataclasses.fields(cls)}


# --- solver checkpoints ---------------------------------------------------------

def test_solver_checkpoint_resume_and_cross_package_load(tmp_path):
    """Interrupted after 3 LM iterations and resumed equals the uninterrupted
    run (costs and poses within 1e-6 relative: one process's float32 on the
    CPU); a checkpoint the JAX package writes loads in the port
    (every array equal) and resumes to the JAX run's result (cost within
    1e-4, poses within 1e-4 m, the JAX test's own bounds)."""
    cam, jp, _, _ = synthetic_ba(P=6, L=80, pose_noise=0.05, lm_noise=0.3, px_noise=0.3, seed=3)
    p, tc = port_problem(jp), port_cam(cam)
    full, full_info = ba.optimize(p, cam=tc, solver=ba.BASolverConfig(max_iterations=8))
    ckpt = str(tmp_path / "port.npz")
    ba.optimize(p, cam=tc, solver=ba.BASolverConfig(max_iterations=3), checkpoint_path=ckpt, checkpoint_every=1)
    resumed, info = ba.optimize(p, cam=tc, solver=ba.BASolverConfig(max_iterations=8), checkpoint_path=ckpt,
                                checkpoint_every=1, resume=True)
    assert info["history"] == pytest.approx(full_info["history"], rel=1e-6)
    assert info["accepted"] == full_info["accepted"] and info["iterations"] == full_info["iterations"]
    for f in ("poses_t", "poses_q", "landmarks"):
        np.testing.assert_allclose(getattr(resumed, f).numpy(), getattr(full, f).numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=f)

    jckpt = str(tmp_path / "jax.npz")
    jba.optimize(jp, cam=cam, solver=jba.BASolverConfig(max_iterations=3), checkpoint_path=jckpt, checkpoint_every=1)
    jprob, jstate = jba.load_solver_checkpoint(jckpt)
    prob, state = ba.load_solver_checkpoint(jckpt)
    assert state == jstate
    mine = prob.to_numpy()
    for f in jp.__dataclass_fields__:
        if getattr(jprob, f) is not None:
            np.testing.assert_array_equal(mine[f], np.asarray(getattr(jprob, f)), err_msg=f)
    jfull, jinfo = jba.optimize(jp, cam=cam, solver=jba.BASolverConfig(max_iterations=8))
    cont, cinfo = ba.optimize(p, cam=tc, solver=ba.BASolverConfig(max_iterations=8), checkpoint_path=jckpt,
                              resume=True)
    assert cinfo["cost"] == pytest.approx(jinfo["cost"], rel=1e-4)
    np.testing.assert_allclose(cont.poses_t.numpy(), np.asarray(jfull.poses_t), atol=1e-4)

    ours = str(tmp_path / "rt.npz")
    st = {"round": 1, "iter": 4, "lambda": 2.5e-4, "history": [10.0, 5.0, 3.0], "accepted": 2, "trimmed": 7}
    ba.save_solver_checkpoint(ours, p, st)
    jprob2, jstate2 = jba.load_solver_checkpoint(ours)
    assert jstate2 == st
    np.testing.assert_array_equal(np.asarray(jprob2.lm_obs), np.asarray(jp.lm_obs))


# --- evaluate -------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["umeyama_alignment", "ate_rmse", "rpe_rmse"])
def test_metrics_equal_the_jax_packages(fn):
    rng = np.random.default_rng(7)
    est, gt = rng.normal(size=(30, 3)), rng.normal(size=(30, 3))
    for kwargs in ({}, {"with_scale": True}) if fn != "rpe_rmse" else ({}, {"delta": 3}):
        ours, theirs = getattr(metrics, fn)(est, gt, **kwargs), getattr(jmetrics, fn)(est, gt, **kwargs)
        for a, b in zip(np.atleast_1d(ours) if fn != "umeyama_alignment" else ours,
                        np.atleast_1d(theirs) if fn != "umeyama_alignment" else theirs):
            np.testing.assert_array_equal(a, b)


def test_evaluate_cli_equals_the_jax_packages(tmp_path, capsys):
    """Both evaluate CLIs on the same estimate and KITTI ground truth print
    the same JSON; a missing file fails both."""
    from tests.test_io import make_problem
    from vision_slam_frontend_tpu.cli import evaluate as jeval
    from vision_slam_frontend_tpu_torch.cli import evaluate

    est = str(tmp_path / "est.npz")
    serialize.save_problem(est, make_problem())
    rng = np.random.default_rng(8)
    traj = np.array([n.pose.loc for n in make_problem().nodes], np.float64) + rng.normal(0, 0.1, (3, 3))
    gt = str(tmp_path / "gt.txt")
    np.savetxt(gt, np.array([np.hstack([np.eye(3), t[:, None]]).ravel() for t in traj]))
    out = []
    for main in (evaluate.main, jeval.main):
        assert main(["--est", est, "--gt", gt, "--delta", "1"]) == 0
        out.append(json.loads(capsys.readouterr().out.strip().splitlines()[-1]))
    assert out[0] == out[1] and out[0]["num_poses"] == 3
    assert evaluate.main(["--est", str(tmp_path / "nope.npz"), "--gt", gt]) == 1


@pytest.mark.parametrize("tables", [True, False], ids=["gather_tables", "scatter"])
def test_refit_landmarks_equals_the_jax_packages(tables):
    """Landmark-only Gauss-Newton with the poses held, on a stereo problem
    (every landmark constrained; monocular ones drift along their rays by
    thousands of metres in both packages): 3 iterations, within 2e-4 of the
    largest landmark coordinate (measured 4.8e-5, one weak landmark)."""
    cam, jp, _, _ = jax_synthetic_ba(P=12, L=200, stereo=True, lm_noise=0.3, seed=2, gather_tables=tables)
    theirs = jba.refit_landmarks(cam, jp, jnp.float32(4.0), 3, True)
    ours = ba.refit_landmarks(port_cam(cam), port_problem(jp), 4.0, 3, True)
    close(ours.landmarks, theirs.landmarks, 2e-4, "landmarks")
    assert torch.equal(ours.poses_t, port_problem(jp).poses_t)


def test_validate_hook_checks_each_step():
    from vision_slam_frontend_tpu_torch.utils.checks import InvariantViolation, check_ba_step

    cam, jp, _, _ = synthetic_ba(P=7, L=90, pose_noise=0.04, lm_noise=0.25, seed=5)
    _, info = ba.optimize(port_problem(jp), cam=port_cam(cam), solver=ba.BASolverConfig(max_iterations=3,
                                                                                        validate=True))
    assert info["accepted"] >= 1
    check_ba_step(0, torch.zeros(2, 6), np.zeros((3, 3)))
    for d_pose, d_lm, what in ((torch.full((2, 6), float("nan")), torch.zeros(3, 3), "pose"),
                               (torch.zeros(2, 6), torch.tensor([[float("inf"), 0, 0]]), "landmark")):
        with pytest.raises(InvariantViolation, match=f"non-finite {what} update"):
            check_ba_step(4, d_pose, d_lm)


def test_camera_from_config_equals_the_jax_packages():
    """CameraParams.from_config on the synthetic rig's calibration, left and
    right cameras and the rig's extrinsics: every field equal."""
    from vision_slam_frontend_tpu.frontend.config import FrontendConfig as JaxConfig
    from vision_slam_frontend_tpu.io.synthetic import SyntheticRig
    from vision_slam_frontend_tpu_torch.frontend.config import FrontendConfig

    theirs = jres.CameraParams.from_config(JaxConfig(calib=SyntheticRig().calib()))
    ours = res.CameraParams.from_config(FrontendConfig(calib=SyntheticRig().calib()), device=CPU)
    for f in theirs.__dataclass_fields__:
        assert getattr(ours, f).dtype == torch.float32, f
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(theirs, f)), err_msg=f)
