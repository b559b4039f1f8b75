"""The port's segment-parallel BA (vision_slam_frontend_tpu_torch/parallel/
segment_ba.py) against the JAX package's, on the CPU: the partition's arrays
exactly, the level-B alignment, one level-A iteration against the
reference's per-segment dense step, and whole runs held to every assertion
of tests/test_segment_ba.py, on one process and on 8 in-process shards.
Helpers and tolerances: tests/test_torch_backend.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from tests.test_torch_backend import CPU, close, port_cam, port_problem  # noqa: E402
from vision_slam_frontend_tpu.backend import ba as jba  # noqa: E402
from vision_slam_frontend_tpu.io.synthetic import synthetic_ba_problem as jax_synthetic_ba  # noqa: E402
from vision_slam_frontend_tpu.parallel import segment_ba as jseg  # noqa: E402
from vision_slam_frontend_tpu_torch.backend import ba  # noqa: E402
from vision_slam_frontend_tpu_torch.backend.metrics import ate_rmse  # noqa: E402
from vision_slam_frontend_tpu_torch.parallel import make_mesh  # noqa: E402
from vision_slam_frontend_tpu_torch.parallel import segment_ba as seg  # noqa: E402

W = tuple(ba._round_f32(x) for x in (4.0, 30.0, 60.0))  # Huber delta, odometry weights


@pytest.fixture(scope="module")
def world():
    """tests/test_segment_ba.py's fixture, in both packages."""
    cam, jp, gt_t, gt_lm = jax_synthetic_ba(P=128, L=2048, obs_per_lm=5, seed=3, stereo=True, pose_noise=0.08)
    return cam, jp, port_cam(cam), port_problem(jp), gt_t


@pytest.fixture(scope="module")
def runs(world):
    """tests/test_segment_ba.py's joint and segment runs (12 LM iterations,
    n_seg=4, sweeps 4): the port's optimize and optimize_segments, and the
    JAX package's optimize_segments, each once."""
    jcam, jp, cam, p, _ = world
    solver = ba.BASolverConfig(max_iterations=12)
    return {
        "joint": ba.optimize(p, cam=cam, solver=solver),
        "segments": seg.optimize_segments(p, cam=cam, solver=solver, n_seg=4, sweeps=4),
        "reference": jseg.optimize_segments(jp, cam=jcam, solver=jba.BASolverConfig(max_iterations=12), n_seg=4,
                                            sweeps=4),
    }


@pytest.mark.parametrize("offset", [0, 8, 13])
def test_build_segments_equals_the_jax_packages(world, offset):
    """Every stacked array and every info table equal, dtype and all, and the
    partition invariants of tests/test_segment_ba.py."""
    _, jp, _, p, _ = world
    theirs, tinfo = jseg.build_segments(jp, 8, offset=offset)
    ours, info = seg.build_segments(p, 8, offset=offset)
    for f in theirs.__dataclass_fields__:
        v = getattr(theirs, f)
        if v is None:
            assert getattr(ours, f) is None, f
            continue
        mine, v = getattr(ours, f), np.asarray(v)
        assert mine.dtype == v.dtype and mine.shape == v.shape, f
        np.testing.assert_array_equal(mine, v, err_msg=f)
    assert sorted(info) == sorted(tinfo)
    for k in tinfo:
        a, b = np.asarray(info[k]), np.asarray(tinfo[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    own = info["pose_own"]
    assert sorted(info["pose_gid"][own].tolist()) == list(range(p.num_poses))
    assert int(ours.obs_mask.sum()) == int(p.obs_mask.sum())
    assert int(ours.odom_mask.sum()) + info["jn_a"].shape[0] == int(p.odom_mask.sum())
    owned = info["lm_gid"][info["lm_own"]]
    assert len(owned) == len(set(owned.tolist())) == len(set(p.obs_landmark[p.obs_mask].tolist()))
    assert bool(ours.pose_fixed[:, 0].all())


def test_build_segments_rejects_an_invalid_n_seg(world):
    p = world[3]
    for n_seg in (0, 10_000):
        with pytest.raises(ValueError, match="invalid"):
            seg.build_segments(p, n_seg)


def _rigidly_displaced(jp, n_seg, seed=4):
    """build_segments' stacked problem with each segment's poses and
    landmarks moved by its own small rigid motion (segment 0's too): the
    drift level B corrects."""
    from vision_slam_frontend_tpu_torch.utils import np_geom

    stacked, info = jseg.build_segments(jp, n_seg)
    rng = np.random.default_rng(seed)
    st, sq, sl = (np.asarray(x).copy() for x in (stacked.poses_t, stacked.poses_q, stacked.landmarks))
    for k in range(n_seg):
        aa, u = rng.normal(0, 0.01, 3), rng.normal(0, 0.05, 3)
        R = np_geom.axis_angle_to_matrix(aa)
        st[k] = st[k] @ R.T + u
        sl[k] = sl[k] @ R.T + u
        sq[k] = np_geom.quat_multiply_batch(np.broadcast_to(np_geom.axis_angle_to_quat(aa), sq[k].shape), sq[k])
    return stacked.replace(poses_t=st.astype(np.float32), poses_q=sq.astype(np.float32),
                           landmarks=sl.astype(np.float32)), info


def test_alignment_equals_the_jax_packages(world):
    """Level B (alignment_gather + _align_segments) on the same displaced
    stacked state: xi within 1e-4 of the reference's, segment 0 pinned."""
    _, jp, _, _, _ = world
    stacked, info = _rigidly_displaced(jp, 4)
    theirs = jseg._align_segments(stacked, info, 30.0, 60.0, 3.0)
    ours = seg._align_segments(*(torch.from_numpy(getattr(stacked, f)) for f in ("poses_t", "poses_q", "landmarks")),
                               info, 30.0, 60.0, 3.0)
    assert float(np.abs(theirs).max()) > 1e-3  # there is drift to correct
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-4)
    assert float(ours[0].abs().max()) == 0.0


# Per-segment lambdas of the level-A comparison, and its tolerances for each
# world: the largest |port - reference| of the pose and landmark steps over
# the largest entry of the reference's, and the relative difference of the
# cost after the step; each 3 to 5 times what was measured. Both packages'
# dense steps have the same coupling arithmetic; what differs is their float32
# linearization and Schur terms, which these segments' conditioning at small
# lambda amplifies: the JAX package's own two dense paths (_linearize_pm +
# _solve_schur_dense_pm against _linearize + _solve_schur_dense) differ on
# the repeated-slot world's segments by up to 1.5e-3 / 3.3e-3 at lambda 1e-3.
# Measured: pose 1.0e-3, landmarks 1.9e-3, cost 2.1e-4 (one slot per
# (landmark, pose)); 2.4e-3, 3.1e-3, 1.4e-3 (repeated slots). Against the
# port's own dense step on each segment alone (the same arithmetic on a (Ps,
# ...) batch instead of (4 Ps, ...), one Cholesky per segment): within 1e-3 of
# the largest entry (measured 2.5e-4 in either world: the batched products
# round in another order, and S's conditioning amplifies it).
LEVEL_A_LAMBDAS = (1e-3, 1.0, 1e-3, 1.0)
LEVEL_A_TOL = {"one_slot_per_pose": (4e-3, 8e-3, 1e-3), "repeated_slots": (1e-2, 1.2e-2, 5e-3)}


def _level_a_check(jcam, jp, cam, tol):
    """One level-A iteration of the folded problem (every segment's dense
    step at its own lambda, one batched Cholesky) against each segment's
    step alone: the port's _dense_core on the unfolded segment, and the
    reference's per-segment _linearize + _solve_schur_dense + _apply_step,
    held to `tol` (LEVEL_A_TOL's)."""
    tol_pose, tol_lm, tol_cost = tol
    stacked, _ = jseg.build_segments(jp, 4)
    Ps, Ls = stacked.poses_t.shape[1], stacked.landmarks.shape[1]
    folded = seg.fold_segments(stacked, slice(0, 4), CPU)
    plan = ba._dense_coupling_plan(folded, Ps)
    lam = torch.tensor(LEVEL_A_LAMBDAS)
    cand, costs = seg.level_a_iteration(cam, folded, ba._build_pm_inputs(folded), plan, lam, 4, Ps, *W, True)
    jw = tuple(jnp.float32(x) for x in W)
    for k, lam_k in enumerate(LEVEL_A_LAMBDAS):
        rows, lms = slice(k * Ps, (k + 1) * Ps), slice(k * Ls, (k + 1) * Ls)
        d_pose_ours = cand.poses_t[rows] - folded.poses_t[rows]
        d_lm_ours = cand.landmarks[lms] - folded.landmarks[lms]
        # The port's own step on the segment alone.
        alone = seg.fold_segments(stacked, slice(k, k + 1), CPU)
        pm = ba._build_pm_inputs(alone)
        d_pose, d_lm, _ = ba._dense_core(pm, *ba._linearize_pm(cam, alone, pm, *W, True), alone, lam_k, False)
        single = ba._apply_step(alone, d_pose, d_lm)
        close(d_pose_ours, (single.poses_t - alone.poses_t).numpy(), 1e-3, f"segment {k} pose step, port alone")
        close(d_lm_ours, (single.landmarks - alone.landmarks).numpy(), 1e-3, f"segment {k} landmark step, port alone")
        # The reference's per-segment step.
        pk = jba.BAProblem(**{f: jnp.asarray(np.asarray(getattr(stacked, f))[k])
                              for f in stacked.__dataclass_fields__ if getattr(stacked, f) is not None})
        d_pose, d_lm, _ = jba._solve_schur_dense(*jba._linearize(jcam, pk, *jw, True), pk, jnp.float32(lam_k), False)
        theirs = jba._apply_step(pk, d_pose, d_lm)
        close(d_pose_ours, np.asarray(theirs.poses_t) - np.asarray(pk.poses_t), tol_pose, f"segment {k} pose step")
        close(d_lm_ours, np.asarray(theirs.landmarks) - np.asarray(pk.landmarks), tol_lm, f"segment {k} landmark step")
        assert float(costs[k]) == pytest.approx(float(jba.compute_cost(jcam, theirs, *jw, True)), rel=tol_cost)
        assert float(d_pose_ours[0].abs().max()) == 0.0  # the local gauge


def test_level_a_iteration_equals_the_per_segment_steps(world):
    """_level_a_check on tests/test_segment_ba.py's world (one slot per
    (landmark, pose))."""
    jcam, jp, cam, _, _ = world
    _level_a_check(jcam, jp, cam, LEVEL_A_TOL["one_slot_per_pose"])


def test_level_a_iteration_with_repeated_slots_equals_the_per_segment_steps(world):
    """_level_a_check on the same world with a second slot of every other
    landmark on the pose of its first (tests/test_torch_parallel.py's
    _with_repeated_slots): the folded plan's placement per (landmark, pose)
    inside its diagonal blocks of `block_poses` poses."""
    from tests.test_torch_parallel import _with_repeated_slots

    jcam, jp, cam, _, _ = world
    jp, n = _with_repeated_slots(jp)
    assert n == 1016
    _level_a_check(jcam, jp, cam, LEVEL_A_TOL["repeated_slots"])


def test_segments_match_the_joint_optimum(world, runs):
    """tests/test_segment_ba.py::test_matches_joint_optimum against the
    port's own optimize, and the final cost within 2% of the JAX package's
    optimize_segments on the same problem."""
    _, jp, _, p, gt_t = world
    (opt_g, info_g), (opt_s, info_s), (_, info_ref) = runs["joint"], runs["segments"], runs["reference"]
    assert info_s["cost"] < 1.02 * info_g["cost"] + 1e-6
    assert info_s["cost"] < 0.01 * info_s["history"][0]
    ate_g = ate_rmse(opt_g.poses_t.numpy(), gt_t, align=False)
    ate_s = ate_rmse(opt_s.poses_t.numpy(), gt_t, align=False)
    ate_0 = ate_rmse(p.poses_t.numpy(), gt_t, align=False)
    assert ate_s < ate_0
    assert ate_s < 2.0 * ate_g + 5e-3
    assert abs(info_s["cost"] - info_ref["cost"]) <= 0.02 * info_ref["cost"]
    assert info_s["segments"] == 4 and info_s["sweeps"] == 4


def test_segments_history_is_monotone(world):
    _, _, cam, p, _ = world
    _, info = seg.optimize_segments(p, cam=cam, solver=ba.BASolverConfig(max_iterations=6), n_seg=4, sweeps=3,
                                    polish_iterations=0)
    h = info["history"]
    assert all(b <= a + 1e-6 for a, b in zip(h[:-1], h[1:]))


def test_eight_in_process_shards_match_the_unsharded_run(world):
    """tests/test_segment_ba.py::test_sharded_matches_unsharded: the segments
    split over 8 in-process shards (level A per shard, the state gathered
    for level B) against one process: cost within 1e-2, poses within 2e-3;
    the group counted its gathers."""
    _, _, cam, p, _ = world
    solver = ba.BASolverConfig(max_iterations=8)
    mesh = make_mesh(8, CPU)
    opt_u, info_u = seg.optimize_segments(p, cam=cam, solver=solver, n_seg=8, sweeps=2, polish_iterations=0)
    opt_m, info_m = seg.optimize_segments(p, mesh=mesh, cam=cam, solver=solver, n_seg=8, sweeps=2,
                                          polish_iterations=0)
    assert abs(info_m["cost"] - info_u["cost"]) < 1e-2 * info_u["cost"] + 1e-3
    np.testing.assert_allclose(opt_m.poses_t.numpy(), opt_u.poses_t.numpy(), atol=2e-3)
    assert mesh.calls > 0
    with pytest.raises(ValueError, match="does not split"):
        seg.optimize_segments(p, mesh=mesh, cam=cam, solver=solver, n_seg=12, sweeps=1)


def test_beyond_the_dense_ceiling():
    """tests/test_segment_ba.py::test_beyond_dense_ceiling at a small P, its
    dense_max_poses pinned below P as that test does: a drifting trajectory
    on 8 in-process shards, segments + the sharded PCG polish, below 0.01 of
    the initial cost and below twice the ground truth's."""
    P = 128
    jcam, jp, gt_t, gt_lm = jax_synthetic_ba(P=P, L=2048, obs_per_lm=4, seed=7, stereo=True, pose_noise=0.01,
                                             pose_walk=0.02)
    cam, p = port_cam(jcam), port_problem(jp)
    solver = ba.BASolverConfig(max_iterations=8, dense_max_poses=64, dense_chunked_max_poses=64)
    assert p.num_poses > solver.dense_max_poses
    _, info = seg.optimize_segments(p, mesh=make_mesh(8, CPU), cam=cam, solver=solver, n_seg=8, sweeps=2,
                                    polish_iterations=2)
    assert np.isfinite(info["cost"])
    assert info["cost"] < 0.01 * info["history"][0]
    yaw = 0.005 * np.arange(P)
    gt_q = np.stack([np.cos(yaw / 2), np.zeros(P), np.sin(yaw / 2), np.zeros(P)], -1).astype(np.float32)
    gt = p.replace(poses_t=torch.from_numpy(gt_t), poses_q=torch.from_numpy(gt_q), landmarks=torch.from_numpy(gt_lm))
    assert info["cost"] < 2.0 * float(ba.compute_cost(cam, gt, *W, True))
