"""The port's pose-major Schur-PCG route (backend/ba.py, what `auto` selects
past dense_max_poses) against its plain reference
slam_bench/reference/ba_pcg_ref.py (the route's step solved exactly, in
float64), the benchmark cell that measures it (kitti00_ba_pcg_p4541: its
driver kind slam_bench/drivers/ba_offline_pcg.py, its limits, its readers),
and the route's spans and counters. CPU, seeded, small sizes."""

from __future__ import annotations

import ast
import collections
import contextlib
import json
import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from slam_bench import ba_problem, common, roofline_pcg, run
from slam_bench.drivers import ba_offline_pcg
from slam_bench.drivers.ba_offline import _program_problem
from slam_bench.reference import ba_pcg_ref, ba_ref
from slam_bench.tiny import tiny_copy
from vision_slam_frontend_tpu_torch.backend import ba
from vision_slam_frontend_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CELL = "kitti00_ba_pcg_p4541"
CONFIG = json.loads((ROOT / "slam_bench" / "configs" / "kitti00_global_ba.json").read_text())
TRAFFIC = json.loads((ROOT / "slam_bench" / "traffic" / "ba_offline_pcg_p4541_l908k.json").read_text())
# PCG at any size: both of auto's dense windows below P.
PCG = {"dense_max_poses": 16, "dense_chunked_max_poses": 16}
# The size of the route checks and of the cell's faults: 64 CG iterations do
# not converge here, as they do not at the cell's size.
FAULT_P = 150


def small_traffic(P: int) -> dict:
    """The cell's traffic at P keyframes with its density (20 new landmarks
    a keyframe here, 200 there), on the PCG route with the program's default
    CG and LM iteration counts."""
    return dict(TRAFFIC, poses=P, landmarks=20 * P, solver=dict(PCG))


def program_and_reference(P: int, cg_iterations: int, seed: int, ref_cg_iterations: int | None = None):
    """The port's optimize and ba_pcg_ref.solve from one generated problem:
    ((t, q, lm, reported cost) of the port, the reference problem, (t, q, lm,
    cost) of the reference), the reference's step exact or of
    `ref_cg_iterations` PCG iterations."""
    prob = ba_problem.make(CONFIG, small_traffic(P), seed, "cpu")
    arrays = ba_problem.program_arrays(prob)
    cam = ba_problem.camera(CONFIG)
    problem, camera = _program_problem(arrays, cam, "cpu")
    solver = ba.BASolverConfig(cg_iterations=cg_iterations, **PCG)
    assert ba._solver_form(problem, solver) == "pcg"
    out, info = ba.optimize(problem, solver=solver, cam=camera)
    ref_in = dict(prob, poses_t=arrays["poses_t"], poses_q=arrays["poses_q"], landmarks=arrays["landmarks"],
                  pixel=prob["pixel"].astype(np.float32), pixel_right=prob["pixel_right"].astype(np.float32),
                  odom_t=arrays["odom_t"], odom_q=arrays["odom_q"])
    ref = ba_pcg_ref.Problem(ref_in, cam, "cpu", cg_iterations=ref_cg_iterations)
    rt, rq, rl, rcost, _ = ba_pcg_ref.solve(ref, solver.max_iterations)
    return (out.poses_t, out.poses_q, out.landmarks, info["cost"]), ref, (rt, rq, rl, rcost)


# --- auto's choice at the cell's size.


@pytest.mark.parametrize("P, form", [(4541, "pcg"), (2049, "pcg"), (2048, "dense"), (500, "dense")])
def test_auto_selects_pcg_past_2048_poses_on_defaults(P, form):
    problem = types.SimpleNamespace(pose_obs=torch.zeros(1), num_poses=P)
    assert ba._solver_form(problem, ba.BASolverConfig()) == form


# --- The port against ba_pcg_ref.

# With CG run to convergence (6P = 192 unknowns, 3 x 64 iterations), the
# port and the reference solve one system per step, so both reach one
# minimum. Measured over both seeds: cost 1.4e-9 to 2.2e-9 above the
# reference's (the cost is flat at a minimum: a point within float32
# rounding of it costs that much more), poses 3.0e-6 to 3.3e-6 m apart
# (float32 rounding of ~25 m coordinates is 2e-6), landmarks 6.2e-5 to
# 1.3e-4 m apart at the 99th percentile (points 10-40 m deep are 50-100
# times weaker along the ray than across it), quaternions 1e-7. Each
# tolerance leaves 10x or more.
CONVERGED_TOL = dict(cost=3e-8, pose_m=1e-4, landmark_m=1.5e-3)


@pytest.mark.parametrize("seed", [11, 2**31 + 3])
def test_converged_pcg_agrees_with_the_reference(seed):
    (t, q, lm, reported), ref, (rt, rq, rl, rcost) = program_and_reference(32, 192, seed)
    f64 = lambda x: x.to(torch.float64)
    cost = ref.cost(f64(t), f64(q), f64(lm))
    assert abs(cost - rcost) / rcost < CONVERGED_TOL["cost"]
    assert abs(reported - cost) / cost < 1e-5  # the port's float32 sum of ~3,000 terms
    assert float((f64(t) - rt).abs().max()) < CONVERGED_TOL["pose_m"]
    assert float(np.percentile((f64(lm) - rl).norm(dim=-1).numpy(), 99)) < CONVERGED_TOL["landmark_m"]
    assert float((f64(q) - rq).abs().max()) < 1e-5


# At the default 64 CG iterations the port's answer may cost more than the
# reference's, which steps exactly: by the truncation. Measured: P = 32
# (64 iterations against 186 unknowns) 1.4e-9 above, float32 noise; P = 96,
# 4.4e-5 above. The tolerances leave 10x and more; a cut to 4 CG iterations
# reads 1.2e-2 at P = 32 and 4.2e-3 at P = 96.
TRUNCATED_TOL = {32: 3e-8, 96: 5e-4}


@pytest.mark.parametrize("P", sorted(TRUNCATED_TOL))
def test_64_cg_iterations_cost_little_more_than_the_exact_step(P):
    (t, q, lm, _), ref, (_, _, _, rcost) = program_and_reference(P, 64, 5)
    f64 = lambda x: x.to(torch.float64)
    assert (ref.cost(f64(t), f64(q), f64(lm)) - rcost) / rcost < TRUNCATED_TOL[P]


# The route's own 64 CG iterations, in float64 on the assembled S, against
# the port's in float32 matrix-free: the two follow one LM path, and part by
# float32 rounding of the CG's iterates. Measured at P = 150 (64 iterations
# on 894 unknowns leave the step well short of S's solution) over three
# seeds: cost 3.9e-7 to 6.5e-6 apart, poses 0.22 to 1.9 mm, landmarks 0.55
# to 3.9 mm at the 99th percentile; at the cell's size on the H100, 1.6e-6
# to 1.3e-5, 3.7 to 4.3 mm and 3.5 to 4.6 mm. A cut to 4 CG iterations reads
# 1.1e-2 to 2.2e-2, 16 to 24 cm and 25 to 32 cm at P = 150. The tolerances
# leave 3x or more above the measured.
ROUTE_TOL = dict(cost=5e-5, pose_m=0.01, landmark_m=0.02)


@pytest.mark.parametrize("seed", [7, 2**31 + 91])
def test_the_program_follows_the_routes_own_cg_iterations(seed):
    (t, q, lm, _), ref, (rt, _, rl, rcost) = program_and_reference(FAULT_P, 64, seed, ref_cg_iterations=64)
    f64 = lambda x: x.to(torch.float64)
    assert abs(ref.cost(f64(t), f64(q), f64(lm)) - rcost) / rcost < ROUTE_TOL["cost"]
    assert float((f64(t) - rt).abs().max()) < ROUTE_TOL["pose_m"]
    assert float(np.percentile((f64(lm) - rl).norm(dim=-1).numpy(), 99)) < ROUTE_TOL["landmark_m"]


@pytest.mark.parametrize("cg_iterations", [None, 64])
def test_the_reference_step_equals_the_full_normal_equations(cg_iterations):
    """ba_pcg_ref's Schur step on a 3-pose problem, exact or by 64 PCG
    iterations (12 free pose unknowns: CG reaches the solution), equals the
    un-Schured damped normal equations [[U + lam I, W], [W^T, V + lam I]]
    over every free pose and landmark, solved directly."""
    traffic = dict(TRAFFIC, poses=3, landmarks=24, landmark_noise=0.3, pose_noise=0.05)
    prob = ba_problem.make(CONFIG, traffic, 9, "cpu")
    cam = ba_problem.camera(CONFIG)
    ref = ba_pcg_ref.Problem(prob, cam, "cpu", cg_iterations=cg_iterations)
    lam = 0.25
    t, q, lm = ref.t0, ref.q0, ref.lm0
    d_pose, d_lm = ref.step(t, q, lm, lam)

    P, L, N = ref.P, ref.L, ref.op.shape[0]
    r, Jp, Jl = ba_ref.reprojection(ref.cam, t[ref.op], q[ref.op], lm[ref.ol], ref.px, ref.pxr, ref.hr)
    n = torch.sqrt((r * r).sum(-1))
    hw = torch.where(n <= 4.0, torch.ones_like(n), torch.sqrt(4.0 / n))
    ro, Ji, Jj = ref._odom(t, q, jacobians=True)
    J = torch.zeros(4 * N + 6 * (P - 1), 6 * P + 3 * L, dtype=torch.float64)
    for k in range(N):
        p, l_ = int(ref.op[k]), int(ref.ol[k])
        J[4 * k:4 * k + 4, 6 * p:6 * p + 6] = Jp[k] * hw[k]
        J[4 * k:4 * k + 4, 6 * P + 3 * l_:6 * P + 3 * l_ + 3] = Jl[k] * hw[k]
    for k in range(P - 1):
        J[4 * N + 6 * k:4 * N + 6 * k + 6, 6 * k:6 * k + 6] = Ji[k]
        J[4 * N + 6 * k:4 * N + 6 * k + 6, 6 * k + 6:6 * k + 12] = Jj[k]
    res = torch.cat([(r * hw[:, None]).reshape(-1), ro.reshape(-1)])
    free = slice(6, None)  # pose 0 fixed
    H = J[:, free].T @ J[:, free] + lam * torch.eye(J.shape[1] - 6, dtype=torch.float64)
    x = torch.linalg.solve(H, -J[:, free].T @ res)
    assert N > 3 * L // 2 and float(d_pose[0].abs().max()) == 0.0
    assert torch.allclose(d_pose[1:].reshape(-1), x[:6 * (P - 1)], rtol=1e-9, atol=1e-12)
    assert torch.allclose(d_lm.reshape(-1), x[6 * (P - 1):], rtol=1e-9, atol=1e-12)


def test_the_reference_imports_nothing_of_the_port_or_jax():
    for path in (ROOT / "slam_bench" / "reference" / "ba_pcg_ref.py", ROOT / "slam_bench" / "control_pcg.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "vision_slam_frontend_tpu",
                                                  "vision_slam_frontend_tpu_torch"), (path.name, name)


# --- The cell's run at a small size: sound, and with a fault planted.


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    """The benchmark copied with `pcg_small_cell`: the cell's configuration,
    its traffic at FAULT_P keyframes, its limits file as it is."""
    dest = tmp_path_factory.mktemp("pcg")
    bench = tiny_copy(dest)
    (bench / "traffic" / "pcg_small.json").write_text(json.dumps(small_traffic(FAULT_P)))
    (bench / "limits" / "pcg_small_cell.json").write_text((bench / "limits" / f"{CELL}.json").read_text())
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "pcg_small_cell", "config": "kitti00_global_ba", "traffic": "pcg_small",
                              "chips": 1, "why": "the cell at a small size"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("pcg_small_cell")
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return bench


def _checks(bench):
    res = run.run_cell("pcg_small_cell", 2**31 + 91, 0.3, False, device="cpu", bench_dir=bench)
    assert any(line.startswith("route: pcg") for line in res["notes"])
    return res


def test_a_sound_small_run_is_correct(bench):
    res = _checks(bench)
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == set(json.loads((ROOT / "slam_bench" / "limits" / f"{CELL}.json").read_text())["limits"])


@pytest.mark.parametrize("kind", ["cg_cut_to_4", "default_cg_iterations_4", "backsub_skipped", "pose_moved_5cm"])
def test_a_broken_pcg_solve_is_not_correct(bench, monkeypatch, kind):
    if kind == "cg_cut_to_4":
        real = ba._run_pcg
        monkeypatch.setattr(ba, "_run_pcg", lambda b, S, M, n: real(b, S, M, min(n, 4)))
    elif kind == "default_cg_iterations_4":
        # The program's own default lowered: the references keep the 64 CG
        # iterations the configuration states, so the cut shows.
        real = ba.BASolverConfig
        monkeypatch.setattr(ba, "BASolverConfig", lambda **kw: real(**{"cg_iterations": 4, **kw}))
    elif kind == "backsub_skipped":
        monkeypatch.setattr(ba, "_pm_backsub", lambda state, g_lm, d_pose: torch.zeros_like(g_lm))
    else:
        real = ba.optimize

        def optimize(problem, *args, **kwargs):
            out, info = real(problem, *args, **kwargs)
            t = out.poses_t.clone()
            t[FAULT_P // 2, 0] += 0.05
            return out.replace(poses_t=t), info

        monkeypatch.setattr(ba, "optimize", optimize)
    assert _checks(bench)["correct"] is False


def test_the_driver_refuses_another_route_and_the_full_size_on_the_cpu(bench):
    """Also a traffic whose solver sets another CG count than the
    configuration states."""
    spec_path = bench.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    (bench / "traffic" / "pcg_dense.json").write_text(json.dumps(dict(small_traffic(FAULT_P), solver={})))
    (bench / "limits" / "pcg_dense_cell.json").write_text((bench / "limits" / f"{CELL}.json").read_text())
    spec["workloads"].append({"name": "pcg_dense_cell", "config": "kitti00_global_ba", "traffic": "pcg_dense",
                              "chips": 1, "why": "auto takes dense at this size"})
    spec["workloads"].append({"name": "pcg_full_cell", "config": "kitti00_global_ba",
                              "traffic": "ba_offline_pcg_p4541_l908k", "chips": 1, "why": "the full size"})
    (bench / "limits" / "pcg_full_cell.json").write_text((bench / "limits" / f"{CELL}.json").read_text())
    (bench / "traffic" / "pcg_cg32.json").write_text(
        json.dumps(dict(small_traffic(FAULT_P), solver=dict(PCG, cg_iterations=32))))
    (bench / "limits" / "pcg_cg32_cell.json").write_text((bench / "limits" / f"{CELL}.json").read_text())
    spec["workloads"].append({"name": "pcg_cg32_cell", "config": "kitti00_global_ba", "traffic": "pcg_cg32",
                              "chips": 1, "why": "another CG count than the configuration states"})
    spec_path.write_text(json.dumps(spec))
    with pytest.raises(common.Refused, match="'dense' route"):
        run.run_cell("pcg_dense_cell", 3, 0.1, False, device="cpu", bench_dir=bench)
    with pytest.raises(common.Refused, match="a size for the card"):
        run.run_cell("pcg_full_cell", 3, 0.1, False, device="cpu", bench_dir=bench)
    with pytest.raises(common.Refused, match="against the configuration's"):
        run.run_cell("pcg_cg32_cell", 3, 0.1, False, device="cpu", bench_dir=bench)


# --- The route's spans and counters.


class _Ops(TorchDispatchMode):
    """Counts every op dispatched inside it, but the profiler's own
    (record_function's enter and exit)."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        if not str(func).startswith("profiler."):
            self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def _pcg_problem():
    prob = ba_problem.make(CONFIG, small_traffic(24), 4, "cpu")
    return _program_problem(ba_problem.program_arrays(prob), ba_problem.camera(CONFIG), "cpu")


def _optimize(record: bool):
    problem, camera = _pcg_problem()
    profiling.clear_spans()
    profiling.clear_counters()
    solver = ba.BASolverConfig(cg_iterations=16, **PCG)
    ops = _Ops()
    with (profile(activities=[ProfilerActivity.CPU]) if record else contextlib.nullcontext()), ops:
        out, info = ba.optimize(problem, solver=solver, cam=camera)
    return out, info, ops.ops, profiling.recorded_spans(), profiling.recorded_counters()


def test_the_route_records_nothing_and_adds_no_op_with_the_profiler_off():
    out_off, info_off, ops_off, spans_off, counters_off = _optimize(False)
    out_on, info_on, ops_on, _, counters_on = _optimize(True)
    assert spans_off == [] and counters_off == []
    assert info_off["history"] == info_on["history"]
    assert torch.equal(out_off.poses_t, out_on.poses_t) and torch.equal(out_off.landmarks, out_on.landmarks)
    # Off, the route's ops are the untraced ones: one host fetch of the cost an
    # iteration (and the first cost's). Recording adds |b|, the ratio and the
    # stacked fetch (CPU tensors' tolist() dispatches no op), and nothing else.
    n = info_on["iterations"]
    fetch = "aten._local_scalar_dense.default"
    assert n > 1 and ops_off[fetch] == n + 1
    assert ops_off - ops_on == collections.Counter({fetch: n})
    assert ops_on - ops_off == collections.Counter(
        {"aten.linalg_vector_norm.default": n, "aten.div.Tensor": n, "aten.stack.default": n})
    assert len(counters_on) == 2 * n


def test_each_lm_iteration_holds_one_pcg_span_and_one_counter_pair():
    _, info, _, spans, counters = _optimize(True)
    iters = [s for s in spans if s.name == "ba.iteration"]
    assert len(iters) == info["iterations"] > 1
    by_id = {s.sid: s for s in spans}
    for name in ("ba.pcg", "ba.backsub"):
        got = [s for s in spans if s.name == name]
        assert [s.request for s in got] == [s.request for s in iters]
        assert {by_id[s.parent].name for s in got} == {"ba.linear_solve"}
        assert all(by_id[s.parent].t0 <= s.t0 <= s.t1 <= by_id[s.parent].t1 for s in got)
    for name in ("ba.cg_iterations", "ba.cg_residual_rel"):
        got = [c for c in counters if c.name == name]
        assert [c.request for c in got] == [s.request for s in iters]
        assert {c.thread for c in got} == {iters[0].thread}
    assert {c.value for c in counters if c.name == "ba.cg_iterations"} == {16.0}
    rel = [c.value for c in counters if c.name == "ba.cg_residual_rel"]
    assert all(math.isfinite(v) and 0.0 <= v < 1.0 for v in rel)
    profiling.clear_spans()
    profiling.clear_counters()


# --- The cell's readers and its byte count.


def test_the_cg_iteration_byte_count_by_hand():
    # P = 2, Mp = 8, L = 4, Ml = 8, 4 rows: Jacobians 16 slots x 4 rows x 9 x 4 B
    # = 2,304; slot masks and ids 16 x 5 = 80; landmark table and mask 32 x 5 = 160,
    # V^-1 4 x 6 x 4 = 96; odometry 2 x 1 x 144 + 2 x 4 = 296; preconditioner
    # 2 x 144 = 288, vectors 8 x 2 x 24 = 384, gauge 8.
    assert roofline_pcg.cg_iteration_bytes(2, 8, 4, 8, 4) == 2304 + 80 + 160 + 96 + 296 + 288 + 384 + 8
    # The cell: about 0.74 GB, 0.22 ms at 3.35 TB/s.
    ms = roofline_pcg.cg_iteration_ms(4541, 1000, 908200, 8, 4)
    assert 0.2 < ms < 0.24


def _reader(name):
    return common.load_module(common.BENCH_DIR, "layer_metrics", name).read


READERS = ["ba.pcg_launches_per_iter", "ba.cg_iter_ms", "ba.cg_residual_rel", "kernel.pcg_sapply_roofline"]


def _synthetic_ctx(monkeypatch):
    """A PCG slice recording from host 10.005 s to 10.105 s and holding, on
    the trace's clock, two LM iterations' `ba.pcg` ranges as the trace keeps
    them, [0.02, 0.03] and [0.06, 0.07], 5 launch calls inside them and 2
    outside; each kernel launched inside them ran 0.1 ms, outside 1 ms. The
    host's and the trace's clocks are not related: the readers must match
    spans to launches on the trace's clock alone."""
    C = profiling.CounterRecord
    tid = 7
    counters = [C("ba.cg_iterations", 64.0, tid, (0, 0), 10.035), C("ba.cg_residual_rel", 0.25, tid, (0, 0), 10.035),
                C("ba.cg_iterations", 64.0, tid, (0, 1), 10.075), C("ba.cg_residual_rel", 0.05, tid, (0, 1), 10.075),
                C("ba.cg_residual_rel", 0.01, tid, (0, 2), 10.075), C("ba.cg_residual_rel", 9.0, tid, (0, 3), 10.5),
                C("ba.cg_iterations", 64.0, tid + 1, (9, 9), 10.05)]
    monkeypatch.setattr(profiling, "recorded_counters", lambda: counters)
    inside = [0.021, 0.022, 0.025, 0.061, 0.069]
    outside = [0.01, 0.1]
    rec = dict(host0=10.005, host1=10.105, launches=sorted(inside + outside),
               kernel_launches=sorted([(t, 1e-4) for t in inside] + [(t, 1e-3) for t in outside]),
               annotations={"ba.pcg": [(0.02, 0.03), (0.06, 0.07)], "ba.iteration": [(0.0, 0.05), (0.05, 0.1)]})
    return dict(kind="ba", pcg_slice=rec, main_thread=tid, pcg=dict(P=4541, Mp=1000, L=908200, Ml=8, rows=4))


def test_the_pcg_readers_on_a_synthetic_slice(monkeypatch):
    ctx = _synthetic_ctx(monkeypatch)
    got = {name: _reader(name)(ctx) for name in READERS}
    assert got["ba.pcg_launches_per_iter"] == 2.5  # 5 launch calls over 2 LM iterations
    assert got["ba.cg_iter_ms"] == pytest.approx(0.5 / 128)  # 5 x 0.1 ms over 2 x 64 CG iterations
    assert got["ba.cg_residual_rel"] == pytest.approx(0.05)  # median of 0.25, 0.05, 0.01; 9.0 lies past the slice
    bound = roofline_pcg.cg_iteration_ms(4541, 1000, 908200, 8, 4)
    assert got["kernel.pcg_sapply_roofline"] == pytest.approx(100.0 * bound / (0.5 / 128))


@pytest.mark.parametrize("case", ["no_slice", "no_counters_in_the_program", "no_kernel_launches", "a_counter_missing"])
def test_the_pcg_readers_read_nothing_where_there_is_nothing(monkeypatch, case):
    ctx = _synthetic_ctx(monkeypatch)
    if case == "no_slice":
        ctx["pcg_slice"] = None
    elif case == "no_counters_in_the_program":  # no ba.pcg span in the trace, no counter
        monkeypatch.delattr(profiling, "recorded_counters")
        del ctx["pcg_slice"]["annotations"]["ba.pcg"]
    elif case == "no_kernel_launches":
        del ctx["pcg_slice"]["kernel_launches"], ctx["pcg_slice"]["annotations"]
    else:  # one LM iteration's ba.cg_iterations not recorded: no iteration count to divide by
        counters = profiling.recorded_counters()
        monkeypatch.setattr(profiling, "recorded_counters", lambda: counters[1:])
    got = {name: _reader(name)(ctx) for name in READERS}
    if case == "a_counter_missing":
        assert got["ba.pcg_launches_per_iter"] == 2.5 and got["ba.cg_residual_rel"] == pytest.approx(0.05)
        assert got["ba.cg_iter_ms"] is None and got["kernel.pcg_sapply_roofline"] is None
    elif case == "no_kernel_launches":  # the program's counters still read
        assert got == dict.fromkeys(READERS) | {"ba.cg_residual_rel": pytest.approx(0.05)}
    else:
        assert got == dict.fromkeys(READERS)


def test_the_pcg_slice_keeps_launches_and_annotations_on_the_trace_clock():
    """The PCG slice's reading of synthetic trace events (µs): kernels
    matched to their launch calls (runtime or driver API) by correlation id,
    a kernel with no launch call left out; record_function ranges by name."""
    X = lambda cat, name, ts, dur, **args: dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, args=args)
    events = [X("cuda_runtime", "cudaLaunchKernel", 200, 5, correlation=1), X("kernel", "k1", 210, 20, correlation=1),
              X("cuda_driver", "cuLaunchKernel", 300, 5, correlation=2), X("kernel", "k2", 320, 40, correlation=2),
              X("kernel", "k3", 400, 5, correlation=9), X("cuda_runtime", "cudaMemcpyAsync", 500, 5, correlation=4),
              X("user_annotation", "ba.pcg", 250, 100), X("user_annotation", "ba.pcg", 150, 30),
              X("user_annotation", "ba.backsub", 380, 10), X("cpu_op", "aten::mul", 260, 5)]
    assert ba_offline_pcg.kernel_launches(events) == [(2e-4, 2e-5), (3e-4, 4e-5)]
    got = ba_offline_pcg.annotations(events)
    assert sorted(got) == ["ba.backsub", "ba.pcg"]
    assert np.allclose(got["ba.pcg"], [(1.5e-4, 1.8e-4), (2.5e-4, 3.5e-4)], rtol=1e-12)


def test_the_routes_spans_show_in_the_trace_one_pcg_range_an_lm_iteration(tmp_path):
    problem, camera = _pcg_problem()
    profiling.clear_spans()
    profiling.clear_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, info = ba.optimize(problem, solver=ba.BASolverConfig(cg_iterations=16, **PCG), cam=camera)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    got = ba_offline_pcg.annotations(events)
    assert len(got["ba.pcg"]) == len(got["ba.backsub"]) == len(got["ba.iteration"]) == info["iterations"] > 1
    for (a, b), (c, d) in zip(got["ba.pcg"], got["ba.linear_solve"]):
        assert c <= a <= b <= d
    assert len([c for c in profiling.recorded_counters() if c.name == "ba.cg_iterations"]) == info["iterations"]
    profiling.clear_spans()
    profiling.clear_counters()


@pytest.mark.cuda
def test_the_slices_keep_every_kernel_after_a_large_profiled_session():
    """In a process that has profiled a large session, the profiler loses
    the first kernels of each later session and the last of a large one.
    The driver's slices pad their edges: each keeps both markers and every
    kernel between them, and the PCG slice every kernel inside a span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the slices profile the card)")
    x = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(100_000):
            x.add_(1.0)
        torch.cuda.synchronize()
    for _ in range(2):
        s = ba_offline_pcg.Slice()
        for _ in range(100_000):
            x.mul_(1.0)
        rec = s.close()
        assert rec is not None
        assert sum(1 for k in rec["kernels"] if k[3] == "kernel") == 100_000
    s = ba_offline_pcg.PcgSlice()
    with torch.profiler.record_function("ba.pcg"):
        for _ in range(100_000):
            x.mul_(1.0)
    rec = s.close()
    (a, b), = rec["annotations"]["ba.pcg"]
    assert sum(1 for t, _ in rec["kernel_launches"] if a <= t <= b) == 100_000
