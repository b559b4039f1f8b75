"""The port's windowed local BA against the JAX package's, on the CPU.

Mirrors tests/test_merge_localba.py's TestLocalBA and TestPipelinedLocalBA
on the problem of a small run of the port's CLI (synthetic:14, K=192, W=4,
--device cpu), which both packages read through their load_problem. The
device solve is float32 in both packages, the same pre-trim, the same scatter
Schur-PCG and the same accept/reject selection, so the windowed solve is
held to the JAX package's poses within 1e-4 m and its cost history within
1e-5 (measured: 7e-7 m, 4e-7). The pipelined schedule equals the
synchronous one to 1e-5 in the port, and two LocalBAStates interleaved in one
process give each session what it gets alone, bit for bit.

The solve's CUDA graphs (one per capacity bucket, kept by the LocalBAState):
the bucket key, the static inputs against BAProblem.from_numpy and the
bucket's first (eager) run on the CPU; on the card, a session through graphs
against one with graphs held off, bit for bit. Only the parity tests import
the JAX package (the `jx` fixture), so the card test runs on its own where
JAX is not installed:

    python -m pytest --noconftest tests/test_torch_local_ba.py -q -k graph
"""

import copy
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vision_slam_frontend_tpu_torch.backend import ba  # noqa: E402
from vision_slam_frontend_tpu_torch.backend import local_ba as lba  # noqa: E402
from vision_slam_frontend_tpu_torch.backend.residuals import CameraParams  # noqa: E402
from vision_slam_frontend_tpu_torch.backend.tracks import build_ba_arrays  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend import FrontendConfig  # noqa: E402
from vision_slam_frontend_tpu_torch.io import serialize  # noqa: E402
from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig  # noqa: E402
from vision_slam_frontend_tpu_torch.types.slam_types import BAProblem  # noqa: E402

CPU = "cpu"
SMALL = dict(max_features=192, frame_life=4, fast_threshold=12.0)
POSE_ATOL = 1e-4
COST_RTOL = 1e-5


@pytest.fixture(scope="module")
def session_npz(tmp_path_factory):
    """The port's CLI on synthetic:14 at K=192, W=4, on the CPU."""
    from vision_slam_frontend_tpu_torch.cli import slam_frontend

    path = str(tmp_path_factory.mktemp("lba") / "session.npz")
    argv = ["--input", "synthetic:14", "--output", path, "--device", "cpu", "--max_features", "192",
            "--frame_life", "4"]
    assert slam_frontend.main(argv) == 0
    return path


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules that the parity tests hold the port to,
    imported here rather than at the top: the card test of this file runs
    where JAX is not installed."""
    from types import SimpleNamespace

    from vision_slam_frontend_tpu.backend import ba as jba
    from vision_slam_frontend_tpu.backend import local_ba as jlba
    from vision_slam_frontend_tpu.backend import tracks as jtracks
    from vision_slam_frontend_tpu.frontend import FrontendConfig as JaxFrontendConfig
    from vision_slam_frontend_tpu.io import serialize as jser
    from vision_slam_frontend_tpu.io.synthetic import SyntheticRig as JaxRig

    return SimpleNamespace(lba=jlba, ba=jba, tracks=jtracks, FrontendConfig=JaxFrontendConfig, ser=jser, Rig=JaxRig)


@pytest.fixture(scope="module")
def config():
    return FrontendConfig(calib=SyntheticRig().calib(), **SMALL)


@pytest.fixture(scope="module")
def configs(config, jx):
    return config, jx.FrontendConfig(calib=jx.Rig().calib(), **SMALL)


@pytest.fixture
def cuda():
    """The CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (graph capture and replay run only on the card)")
    return torch.device("cuda")


def _corrupt(problem, n_tail: int, seed: int, sigma: float):
    """The reference test's odometry glitch: the last `n_tail` locations
    moved by N(0, sigma) from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    for node in problem.nodes[-n_tail:]:
        node.pose.loc = node.pose.loc + rng.normal(0, sigma, 3).astype(np.float32)
    return problem


def _locs(problem):
    return np.stack([n.pose.loc for n in problem.nodes])


def _quats(problem):
    return np.stack([n.pose.angle for n in problem.nodes])


@pytest.mark.parametrize("start", [0, 3, 7])
def test_slice_problem_equals_the_jax_packages(session_npz, jx, start):
    ours = lba.slice_problem(serialize.load_problem(session_npz), start)
    theirs = jx.lba.slice_problem(jx.ser.load_problem(session_npz), start)
    assert [n.node_idx for n in ours.nodes] == [n.node_idx for n in theirs.nodes]
    assert ours.nodes[0].node_idx == 0 and len(ours.nodes) == len(theirs.nodes)
    np.testing.assert_array_equal(_locs(ours), _locs(theirs))
    assert [(f.pose_idx_initial, f.pose_idx_current, len(f.feature_matches)) for f in ours.vision_factors] == \
        [(f.pose_idx_initial, f.pose_idx_current, len(f.feature_matches)) for f in theirs.vision_factors]
    assert [(f.pose_i, f.pose_j) for f in ours.odometry_factors] == [(f.pose_i, f.pose_j) for f in theirs.odometry_factors]
    for vf in ours.vision_factors:  # factors crossing the window's start are dropped
        assert 0 <= vf.pose_idx_initial < len(ours.nodes) and 0 <= vf.pose_idx_current < len(ours.nodes)


@pytest.mark.parametrize("window", [5, 8])
def test_pad_for_device_equals_the_jax_packages(session_npz, configs, jx, window):
    """_pad_ba_for_device's buckets: every array equal (dtype, shape,
    values), the gather tables dropped."""
    ext = configs[0].left_cam_to_robot
    problem = serialize.load_problem(session_npz)
    start = len(problem.nodes) - window
    sub = lba.slice_problem(problem, start)
    arrays = build_ba_arrays(sub, left_cam_to_robot=ext, gather_tables=False)
    fixed = np.zeros(arrays["poses_t"].shape[0], bool)
    fixed[:2] = True
    arrays["pose_fixed"] = fixed
    ours = lba._pad_ba_for_device(arrays, n_poses=window)

    jsub = jx.lba.slice_problem(jx.ser.load_problem(session_npz), start)
    jproblem = jx.tracks.build_ba_problem(jsub, left_cam_to_robot=np.asarray(configs[1].left_cam_to_robot))
    theirs = jx.lba._pad_ba_for_device(jproblem.replace(pose_fixed=fixed), n_poses=window)
    for f in theirs.__dataclass_fields__:
        v = getattr(theirs, f)
        if v is None:
            assert f not in ours, f
            continue
        v = np.asarray(v)
        assert ours[f].dtype == v.dtype and ours[f].shape == v.shape, f
        np.testing.assert_array_equal(ours[f], v, err_msg=f)
    assert ours["poses_t"].shape[0] == window and ours["landmarks"].shape[0] % 512 == 0
    assert ours["obs_pose"].shape[0] % 2048 == 0 and ours["odom_i"].shape[0] == 32


def test_windowed_local_ba_matches_the_jax_package(session_npz, configs, jx):
    """One synchronous windowed solve on a corrupted tail (the reference
    test's default_rng(0) glitch): the same updated count, the cost history
    within COST_RTOL, poses within POSE_ATOL, and the tail's error against
    the uncorrupted poses falling, as tests/test_merge_localba.py asserts."""
    ours = serialize.load_problem(session_npz)
    truth = _locs(ours)[-2:].copy()
    ours = _corrupt(ours, 2, seed=0, sigma=0.08)
    theirs = _corrupt(jx.ser.load_problem(session_npz), 2, seed=0, sigma=0.08)
    err_before = np.linalg.norm(_locs(ours)[-2:] - truth, axis=1).mean()
    updated, info = lba.windowed_local_ba(ours, configs[0], window=6, fixed_overlap=2, device=CPU)
    j_updated, j_info = jx.lba.windowed_local_ba(theirs, configs[1], window=6, fixed_overlap=2)
    assert updated == j_updated == 4
    np.testing.assert_allclose(info["history"], j_info["history"], rtol=COST_RTOL)
    assert info["cost"] == pytest.approx(j_info["cost"], rel=COST_RTOL)
    np.testing.assert_allclose(_locs(ours), _locs(theirs), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(_quats(ours), _quats(theirs), rtol=0, atol=POSE_ATOL)
    err_after = np.linalg.norm(_locs(ours)[-2:] - truth, axis=1).mean()
    assert info["cost"] < info["history"][0] and err_after < err_before, (err_before, err_after)


def test_local_solve_settings_are_the_reference_literals(jx):
    """hd=5.0 (not BASolverConfig's 4.0), wt=30, wr=60, trim=8, 6 LM
    iterations of 24 CG iterations: the JAX package's call-site literals,
    frozen in one place."""
    assert lba.SOLVE == lba.LocalSolveSettings(huber_delta=5.0, odom_t_weight=30.0, odom_r_weight=60.0, trim=8.0,
                                               iters=6, cg_iters=24)
    assert ba.BASolverConfig().huber_delta == 4.0
    src = inspect.getsource(jx.lba.windowed_local_ba)
    assert "hd=5.0, wt=30.0, wr=60.0, trim=8.0" in src and "iters=6, cg_iters=24" in src
    with pytest.raises(AttributeError):
        lba.SOLVE.huber_delta = 4.0


def _prefix_schedule(base, config, state, window=5):
    """The CLI's schedule on a problem: one call per keyframe arrival over
    growing prefixes (from 4 nodes), pipelined on `state` or synchronous
    when `state` is None; returns the final locations."""
    prob = copy.deepcopy(base)
    all_nodes = prob.nodes
    for upto in range(4, len(all_nodes) + 1):
        prob.nodes = all_nodes[:upto]
        lba.windowed_local_ba(prob, config, window=window, fixed_overlap=2, pipeline=state is not None,
                              state=state, device=CPU)
    if state is not None:
        state.flush()
    prob.nodes = all_nodes
    return _locs(prob)


def test_pipeline_matches_synchronous_schedule(session_npz, configs):
    """Dispatch at keyframe k, apply at k+1: the synchronous schedule's
    trajectory within 1e-5 (the reference test's check, in the port)."""
    base = _corrupt(serialize.load_problem(session_npz), 3, seed=1, sigma=0.06)
    sync = _prefix_schedule(base, configs[0], None)
    piped = _prefix_schedule(base, configs[0], lba.LocalBAState())
    np.testing.assert_allclose(piped, sync, rtol=0, atol=1e-5)
    assert not np.array_equal(sync, _locs(base))


def test_two_states_interleaved_give_each_session_its_own_result(session_npz, configs):
    """Two sessions with a LocalBAState each, their calls interleaved in one
    process: each ends exactly where it ends alone (no shared in-flight
    solve, no shared camera)."""
    config = configs[0]
    other = FrontendConfig(calib=SyntheticRig().calib(), **SMALL)
    a0 = _corrupt(serialize.load_problem(session_npz), 3, seed=2, sigma=0.05)
    b0 = _corrupt(serialize.load_problem(session_npz), 2, seed=3, sigma=0.1)
    alone_a = _prefix_schedule(a0, config, lba.LocalBAState())
    alone_b = _prefix_schedule(b0, other, lba.LocalBAState(), window=6)

    a, b = copy.deepcopy(a0), copy.deepcopy(b0)
    sa, sb = lba.LocalBAState(), lba.LocalBAState()
    nodes_a, nodes_b = a.nodes, b.nodes
    for upto in range(4, len(nodes_a) + 1):
        a.nodes, b.nodes = nodes_a[:upto], nodes_b[:upto]
        lba.windowed_local_ba(a, config, window=5, pipeline=True, state=sa, device=CPU)
        lba.windowed_local_ba(b, other, window=6, pipeline=True, state=sb, device=CPU)
    sb.flush()
    assert sa.in_flight and not sb.in_flight
    sa.flush()
    a.nodes, b.nodes = nodes_a, nodes_b
    np.testing.assert_array_equal(_locs(a), alone_a)
    np.testing.assert_array_equal(_locs(b), alone_b)


def test_pipelined_calls_report_the_previous_solve(session_npz, configs):
    """A pipelined call returns the flushed solve of the call before it
    (node_idx names its newest node); a window too small to solve returns
    what was flushed; pipelining needs the caller's state."""
    problem = serialize.load_problem(session_npz)
    nodes = problem.nodes
    state = lba.LocalBAState()
    problem.nodes = nodes[:3]
    assert lba.windowed_local_ba(problem, configs[0], pipeline=True, state=state, device=CPU) == (0, None)
    assert lba.windowed_local_ba(problem, configs[0], device=CPU) == (0, None)
    problem.nodes = nodes[:6]
    assert lba.windowed_local_ba(problem, configs[0], window=5, pipeline=True, state=state, device=CPU) == (0, None)
    assert state.in_flight
    problem.nodes = nodes[:3]  # too small: the in-flight solve is still flushed and reported
    updated, info = lba.windowed_local_ba(problem, configs[0], pipeline=True, state=state, device=CPU)
    assert updated == 3 and info["node_idx"] == 5 and not state.in_flight
    assert state.flush() == (0, None)
    with pytest.raises(ValueError, match="LocalBAState"):
        lba.windowed_local_ba(problem, configs[0], pipeline=True, device=CPU)


def _arrays(P0: int, L0: int, N0: int, Q0: int, right: bool) -> dict:
    """An unpadded window's arrays (build_ba_arrays' fields) at the given
    counts, every entry valid."""
    rng = np.random.default_rng(0)
    q = np.zeros((P0, 4), np.float32)
    q[:, 0] = 1.0
    out = dict(
        poses_t=rng.normal(size=(P0, 3)).astype(np.float32), poses_q=q, pose_mask=np.ones(P0, bool),
        pose_fixed=np.arange(P0) < 2,
        landmarks=rng.normal(size=(L0, 3)).astype(np.float32), landmark_mask=np.ones(L0, bool),
        obs_pose=rng.integers(0, P0, N0).astype(np.int32), obs_landmark=rng.integers(0, L0, N0).astype(np.int32),
        obs_pixel=rng.normal(size=(N0, 2)).astype(np.float32), obs_mask=np.ones(N0, bool),
        odom_i=np.arange(Q0, dtype=np.int32), odom_j=np.arange(Q0, dtype=np.int32) + 1,
        odom_t=rng.normal(size=(Q0, 3)).astype(np.float32), odom_q=q[:Q0].copy(), odom_mask=np.ones(Q0, bool),
    )
    if right:
        out["obs_pixel_right"] = rng.normal(size=(N0, 2)).astype(np.float32)
        out["obs_right_mask"] = np.ones(N0, bool)
    return out


@pytest.mark.parametrize("counts, window, key", [
    ((5, 300, 1500, 4, True), 5, (5, 512, 2048, 32, True)),
    ((5, 512, 2048, 4, True), 5, (5, 512, 2048, 32, True)),
    ((5, 513, 2049, 4, False), 5, (5, 1024, 4096, 32, False)),
    ((7, 1100, 5000, 40, True), 8, (8, 1536, 6144, 40, True)),
])
def test_bucket_key_is_read_from_the_padded_shapes(counts, window, key):
    """(P, L, N, Q, right observations present, device) of the padded
    window: windows whose counts pad to the same capacities share a bucket."""
    padded = lba._pad_ba_for_device(_arrays(*counts), n_poses=window)
    assert lba._bucket_key(padded, CPU) == key + (torch.device("cpu"),)
    assert padded["landmarks"].shape[0] == key[1] and padded["obs_pose"].shape[0] == key[2]


def test_a_cpu_state_keeps_no_graph_and_gives_the_eager_result(session_npz, config):
    """Synchronous windowed solves on the CPU with a LocalBAState, over the
    session's growing prefixes: the state keeps no graph, and every solve's
    poses, cost history and `accepted` list equal the eager path's
    (window_problem, then _solve_window on the config's camera) bit for bit."""
    base = _corrupt(serialize.load_problem(session_npz), 3, seed=4, sigma=0.06)
    ours, eager = copy.deepcopy(base), copy.deepcopy(base)
    state = lba.LocalBAState()
    cam = CameraParams.from_config(config, device=CPU)
    ours_all, eager_all = copy.deepcopy(base.nodes), copy.deepcopy(base.nodes)
    for upto in range(4, len(base.nodes) + 1):
        ours.nodes, eager.nodes = ours_all[:upto], eager_all[:upto]
        got = lba.windowed_local_ba(ours, config, window=5, state=state, device=CPU)
        start = max(0, upto - 5)
        sub = lba.slice_problem(eager, start)
        k0 = min(2, len(sub.nodes))
        prob = lba.window_problem(sub, config, 5, k0, CPU)
        host = lba._solve_window(cam, prob)
        want = lba._apply(lba._InFlight(eager_all[start:upto], k0, prob.num_poses, host, None))
        assert got == want, upto
        np.testing.assert_array_equal(_locs(ours), _locs(eager))
        np.testing.assert_array_equal(_quats(ours), _quats(eager))
    assert state._graphs == {}


def test_two_states_keep_separate_graph_caches(session_npz, config):
    """Each state keeps its own graph per bucket: one state returns the same
    graph for a bucket it has met and a new one for another bucket, a second
    state never returns the first's, and a new camera drops a state's graphs."""
    a, b = lba.LocalBAState(), lba.LocalBAState()
    small = lba._pad_ba_for_device(_arrays(5, 300, 1500, 4, True), n_poses=5)
    large = lba._pad_ba_for_device(_arrays(5, 700, 1500, 4, True), n_poses=5)
    a.camera(config, CPU)
    ga = a.graph(small, CPU)
    assert a.graph(small, CPU) is ga and a.graph(large, CPU) is not ga and len(a._graphs) == 2
    gb = b.graph(small, CPU)
    assert gb is not ga and len(b._graphs) == 1 and b.graph(small, CPU) is gb
    assert gb.buffer.data_ptr() != ga.buffer.data_ptr()
    a.camera(FrontendConfig(calib=SyntheticRig().calib(), **SMALL), CPU)
    assert a._graphs == {} and len(b._graphs) == 1


def test_a_buckets_static_inputs_equal_from_numpy(session_npz, config):
    """A window written into its bucket's static inputs gives every field
    of BAProblem.from_numpy (dtype, shape, values), each 512 bytes into the
    buffer or a multiple of it; a second window of the bucket overwrites them all; and the
    bucket's first run is the eager solve, bit for bit."""
    problem = serialize.load_problem(session_npz)
    nodes, windows = problem.nodes, []
    for upto in (len(nodes), len(nodes) - 2):  # the session's last window and the one two keyframes before
        problem.nodes = nodes[:upto]
        windows.append(lba.window_arrays(lba.slice_problem(problem, upto - 5), config, 5, 2))
    assert lba._bucket_key(windows[0], CPU) == lba._bucket_key(windows[1], CPU)
    graph = lba.LocalBAState().graph(windows[0], CPU)
    for padded in windows:
        got, want = graph.upload(padded), BAProblem.from_numpy(padded, device=CPU)
        for f in want.__dataclass_fields__:
            w, g = getattr(want, f), getattr(got, f)
            if w is None:
                assert g is None, f
                continue
            assert g.dtype == w.dtype and g.shape == w.shape and (g.data_ptr() - graph.buffer.data_ptr()) % 512 == 0, f
            assert torch.equal(g, w), f
    cam = CameraParams.from_config(config, device=CPU)
    assert torch.equal(graph.run(cam, 0), lba._solve_window(cam, BAProblem.from_numpy(windows[1], device=CPU)))
    assert graph.graph is None and graph.replays == 0


@pytest.mark.cuda
def test_graph_replay_equals_the_eager_solve_over_a_session(cuda, session_npz, config, monkeypatch):
    """The CLI's pipelined schedule on the card over the session's growing
    prefixes, through the state's per-bucket graphs and with graphs held
    off: every flushed solve's poses, cost history and `accepted` list bit
    for bit, and the final poses; a bucket replayed; and a replayed dispatch
    under sync-debug "error"."""
    base = _corrupt(serialize.load_problem(session_npz), 3, seed=1, sigma=0.06)

    def schedule(state):
        prob = copy.deepcopy(base)
        nodes, flushed = prob.nodes, []
        for upto in range(4, len(nodes) + 1):
            prob.nodes = nodes[:upto]
            flushed.append(lba.windowed_local_ba(prob, config, window=5, pipeline=True, state=state, device=cuda))
        flushed.append(state.flush())
        prob.nodes = nodes
        return prob, flushed

    graphed = lba.LocalBAState()
    prob, got = schedule(graphed)
    locs, quats = _locs(prob), _quats(prob)
    assert sum(g.replays for g in graphed._graphs.values()) > 0
    for _ in range(2):  # the last window's bucket run eagerly and captured, if the schedule has not yet
        lba.windowed_local_ba(prob, config, window=5, pipeline=True, state=graphed, device=cuda)
    graphed.flush()
    torch.cuda.synchronize()
    replays = sum(g.replays for g in graphed._graphs.values())
    torch.cuda.set_sync_debug_mode("error")
    try:
        lba.windowed_local_ba(prob, config, window=5, pipeline=True, state=graphed, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert graphed.in_flight and sum(g.replays for g in graphed._graphs.values()) == replays + 1
    assert graphed.flush()[0] == 3

    monkeypatch.setattr(lba.LocalBAState, "graph", lambda self, padded, device: None)
    held_off = lba.LocalBAState()
    eager, want = schedule(held_off)
    assert held_off._graphs == {}
    assert len(got) == len(want) and sum(u for u, _ in got) > 0
    assert got == want
    np.testing.assert_array_equal(locs, _locs(eager))
    np.testing.assert_array_equal(quats, _quats(eager))


def test_host_loop_solver_branch_matches_the_jax_package(session_npz, configs, jx):
    """`solver=` runs optimize() on the window (dense Schur with gather
    tables): against the JAX package's host-loop branch, the same updated
    count, poses within 1e-3 m and final cost within 1e-3 (the dense
    coupling is float32 here and a bf16 split there: tests/test_torch_backend.py
    holds their steps within 2e-2 of each other)."""
    ours = _corrupt(serialize.load_problem(session_npz), 2, seed=0, sigma=0.08)
    theirs = _corrupt(jx.ser.load_problem(session_npz), 2, seed=0, sigma=0.08)
    kw = dict(max_iterations=5, huber_delta=4.0, trim_threshold=8.0)
    updated, info = lba.windowed_local_ba(ours, configs[0], window=6, solver=ba.BASolverConfig(**kw), device=CPU)
    j_updated, j_info = jx.lba.windowed_local_ba(theirs, configs[1], window=6, solver=jx.ba.BASolverConfig(**kw))
    assert updated == j_updated == 4
    assert info["cost"] == pytest.approx(j_info["cost"], rel=1e-3)
    np.testing.assert_allclose(_locs(ours), _locs(theirs), rtol=0, atol=1e-3)


def test_cli_local_ba_end_to_end(tmp_path, capsys):
    """The CLI's pipelined --local_ba loop on the CPU: rc 0, at least 10
    keyframes, finite poses; at -v 2 one [local-ba] line per applied solve,
    naming the keyframe it was dispatched at, and the frame-latency line."""
    from vision_slam_frontend_tpu_torch.cli import slam_frontend

    out = str(tmp_path / "p.npz")
    argv = ["--input", "synthetic:14", "--output", out, "--device", "cpu", "--max_features", "192",
            "--frame_life", "4", "--local_ba", "6", "-v", "2"]
    assert slam_frontend.main(argv) == 0
    printed = capsys.readouterr().out
    d = np.load(out)
    n = len(d["nodes_id"])
    assert n >= 10 and np.isfinite(d["nodes_loc"]).all() and np.isfinite(d["nodes_quat"]).all()
    applied = [ln for ln in printed.splitlines() if ln.startswith("[local-ba] applied")]
    assert len(applied) == n - 3 and applied[-1].startswith(f"[local-ba] applied the solve dispatched at keyframe {n - 1}")
    assert "[perf] frame latency ms p50=" in printed and "peak RSS" in printed


def test_cli_rss_is_the_process_own():
    """The [perf] line's RSS is the CLI process's own: a process started by a
    larger one reports its own, not its parent's peak (getrusage's ru_maxrss
    carries the parent's across fork and exec)."""
    import resource
    import subprocess
    import sys
    from pathlib import Path

    ballast = np.ones(2**25)  # 256 MiB resident in this process
    parent_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    code = "from vision_slam_frontend_tpu_torch.cli.slam_frontend import _rss_mb; print(_rss_mb())"
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, check=True,
                          cwd=Path(__file__).resolve().parents[1])
    child_mb = float(proc.stdout.strip().splitlines()[-1])
    assert 0 < child_mb < parent_mb - ballast.nbytes / 2**20 / 2
