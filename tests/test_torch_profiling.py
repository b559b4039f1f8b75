"""The port's stage profiling (utils/profiling.py, cli/profile_stages.py):
tests/test_profiling.py's two cases run on the port, with the stage keys of
the JAX package's own function at the same size."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from vision_slam_frontend_tpu.frontend.config import FrontendConfig as JaxConfig  # noqa: E402
from vision_slam_frontend_tpu.utils.profiling import profile_keyframe_stages as jax_profile  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend.config import FrontendConfig  # noqa: E402
from vision_slam_frontend_tpu_torch.io.synthetic import SyntheticRig  # noqa: E402
from vision_slam_frontend_tpu_torch.utils.profiling import format_stage_table, profile_keyframe_stages  # noqa: E402

EXPECTED_STAGES = {"detect_describe_x2", "stereo_ratio_match", "epipolar_filter", "window_match", "undistort_x2",
                   "triangulate"}
SMALL = dict(max_features=128, frame_life=3, fast_threshold=12.0)


def test_profile_stages_smoke():
    rig = SyntheticRig(width=320, height=240)
    t = profile_keyframe_stages(FrontendConfig(calib=rig.calib(), **SMALL), image_shape=(240, 320), iters=2,
                                windows=1, device="cpu")
    theirs = jax_profile(JaxConfig(calib=rig.calib(), **SMALL), image_shape=(240, 320), iters=1, windows=1)
    assert set(t) == set(theirs)  # the 12 stages, _stage_sum_ms and _fused_step_ms (no enqueue time on the CPU)
    assert EXPECTED_STAGES <= set(t) and len([k for k in t if not k.startswith("_")]) == 12
    assert all(v > 0 for v in t.values())
    table = format_stage_table(t)
    assert "fused keyframe step" in table
    for s in EXPECTED_STAGES:
        assert s in table
    table = format_stage_table(dict(t, _fused_step_enqueue_ms=0.5))
    assert "of which enqueue" in table


@pytest.mark.parametrize("device_flag", [["--cpu"], ["--device", "cpu"]])
def test_profile_cli(capsys, tmp_path, device_flag):
    from vision_slam_frontend_tpu_torch.cli.profile_stages import TRACE_FILE, main

    rc = main(device_flag + ["--max_features", "128", "--frame_life", "3", "--width", "320", "--height", "240",
                             "--iters", "1", "--windows", "1", "--trace_dir", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "detect_describe_x2" in out and "on cpu" in out and f"Wrote profiler trace to {tmp_path}" in out
    assert (tmp_path / TRACE_FILE).exists()
    # After the trace, the table of the spans recorded meanwhile: the stages of the steps run.
    table = out[out.index("Wrote profiler trace"):]
    assert "total ms" in table and "self ms" in table and "keyframe.extract" in table and "extract.detect" in table


# --- The program's spans (utils/profiling.span), recorded while a profiler records.

import copy  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from tests.test_backend import synthetic_ba  # noqa: E402
from tests.test_torch_backend import port_cam, port_problem  # noqa: E402
from vision_slam_frontend_tpu_torch.backend import ba, local_ba  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend import Frontend  # noqa: E402
from vision_slam_frontend_tpu_torch.io.serialize import problem_to_arrays  # noqa: E402
from vision_slam_frontend_tpu_torch.io.synthetic import generate_sequence  # noqa: E402
from vision_slam_frontend_tpu_torch.utils import profiling  # noqa: E402

STEP_STAGES = ["keyframe.extract", "keyframe.extract", "keyframe.stereo", "keyframe.window_match",
               "keyframe.guided_gate", "keyframe.tracks", "keyframe.geometry"]
LM_STAGES = ["ba.linearize", "ba.assemble", "ba.linear_solve", "ba.step", "ba.sync"]
RIG = SyntheticRig(width=320, height=240)


@pytest.fixture(scope="module")
def stereo_frames():
    return list(generate_sequence(num_frames=7, step=0.25, rig=RIG))


def _recording(record: bool):
    """A CPU profiler when `record`, else nothing; the recorder starts empty."""
    import contextlib

    profiling.clear_spans()
    return profile(activities=[ProfilerActivity.CPU]) if record else contextlib.nullcontext()


def _frontend_run(frames, record: bool, num_levels: int = 2):
    fe = Frontend(FrontendConfig(calib=RIG.calib(), num_levels=num_levels, **SMALL), device="cpu")
    with _recording(record):
        for f in frames:
            fe.observe_odometry(f.odom_translation, f.odom_rotation, f.timestamp)
            fe.observe_image(f.left, f.right, f.timestamp)
        problem = fe.get_slam_problem()
    return problem, fe.node_track_ids, profiling.recorded_spans()


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.sid]


def _assert_nested(spans):
    """Every child lies inside its parent's interval, on its thread."""
    by_id = {s.sid: s for s in spans}
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.t0 <= s.t0 <= s.t1 <= p.t1 and p.thread == s.thread, (p, s)


def test_spans_record_nothing_outside_a_profiler(stereo_frames):
    assert profiling.span("a") is profiling.span("b", 3)  # one shared no-op context
    _, _, spans = _frontend_run(stereo_frames[:3], record=False)
    assert spans == []


def test_frontend_spans_nest_under_each_keyframe(stereo_frames):
    problem, _, spans = _frontend_run(stereo_frames, record=True)
    _assert_nested(spans)
    fids = [n.node_idx for n in problem.nodes]
    observe = [s for s in spans if s.name == "frontend.observe"]
    assert [s.request for s in observe] == fids and len(fids) >= 5
    for k, o in enumerate(observe):
        kids = _children(spans, o)
        names = [c.name for c in kids]
        assert names == ["frontend.upload", "keyframe.step"] + (["frontend.flush"] if k else []) + ["frontend.fetch"]
        assert all(c.request == o.request for c in kids if c.name != "frontend.flush")
        step = kids[1]
        stages = _children(spans, step)
        assert [c.name for c in stages] == STEP_STAGES and {c.request for c in stages} == {o.request}
        for extract in stages[:2]:  # two levels: the pyramid, then each level's detect and describe
            assert [c.name for c in _children(spans, extract)] == ["extract.pyramid"] + [
                "extract.detect", "extract.describe"] * 2
        if k:
            flush = kids[2]
            assert flush.request == fids[k - 1]
            assert [c.name for c in _children(spans, flush)] == ["frontend.accumulate"]  # no event on the CPU
    # The last keyframe is flushed by the accessor, outside any observe.
    last = [s for s in spans if s.name == "frontend.flush" and s.parent is None]
    assert [s.request for s in last] == [fids[-1]]


@pytest.mark.parametrize("solver", [dict(schur_solver="dense"), dict(schur_solver="pcg", cg_iterations=64),
                                    dict(schur_solver="dense", trim_threshold=10.0)])
def test_optimize_records_each_lm_iteration_with_its_stages(solver):
    cam, jp, _, _ = synthetic_ba(pose_noise=0.05, lm_noise=0.2, px_noise=0.3, outlier_frac=0.05, seed=4)
    with _recording(True):
        _, info = ba.optimize(port_problem(jp), cam=port_cam(cam), solver=ba.BASolverConfig(**solver))
    spans = profiling.recorded_spans()
    _assert_nested(spans)
    iters = [s for s in spans if s.name == "ba.iteration"]
    assert len(iters) == info["iterations"] > 0
    solves = {s.request[0] for s in iters}
    assert len(solves) == 1 and [s.request[1] for s in iters] == list(range(len(iters)))
    for it in iters:
        kids = _children(spans, it)
        assert [c.name for c in kids] == LM_STAGES and {c.request for c in kids} == {it.request}


def test_prefetch_records_the_wait_and_the_decode_on_their_threads():
    from vision_slam_frontend_tpu_torch.cli.slam_frontend import prefetch_events

    producer = []

    def source():
        producer.append((threading.get_ident(), threading.current_thread().name))
        for i in range(6):
            yield ("stereo" if i % 2 else "odometry", float(i), i)

    with _recording(True):
        got = list(prefetch_events(source(), depth=2))
    spans = profiling.recorded_spans()
    assert [e[2] for e in got] == list(range(6))
    (tid, name), = producer
    assert name == "vsf-prefetch"
    waits = [s for s in spans if s.name == "input.wait"]
    decodes = [s for s in spans if s.name == "input.decode"]
    assert len(waits) == 7 and {s.thread for s in waits} == {threading.get_ident()}  # six events, then the end
    assert len(decodes) == 7 and {s.thread for s in decodes} == {tid}


def test_local_ba_records_apply_build_and_dispatch_per_window(stereo_frames):
    problem, _, _ = _frontend_run(stereo_frames, record=False)
    config = FrontendConfig(calib=RIG.calib(), **SMALL)
    state = local_ba.LocalBAState()
    prob, nodes = copy.deepcopy(problem), problem.nodes
    with _recording(True):
        for upto in range(4, len(nodes) + 1):
            prob.nodes = nodes[:upto]
            local_ba.windowed_local_ba(prob, config, window=4, pipeline=True, state=state, device="cpu")
        state.flush()
    spans = profiling.recorded_spans()
    _assert_nested(spans)
    dispatched = [n.node_idx for n in nodes[3:]]
    for name in ("local_ba.build", "local_ba.dispatch", "local_ba.apply"):
        assert [s.request for s in spans if s.name == name] == dispatched, name
    assert not [s for s in spans if s.name == "local_ba.apply.wait"]  # no event on the CPU


@pytest.mark.parametrize("path", ["frontend", "ba"])
def test_recording_leaves_the_results_bit_equal(stereo_frames, path):
    if path == "frontend":
        runs = []
        for record in (False, True):
            problem, tracks, _ = _frontend_run(stereo_frames[:5], record)
            runs.append(problem_to_arrays(problem, tracks))
    else:
        cam, jp, _, _ = synthetic_ba(pose_noise=0.05, lm_noise=0.2, seed=4)
        runs = []
        for record in (False, True):
            with _recording(record):
                out, info = ba.optimize(port_problem(jp), cam=port_cam(cam))
            runs.append(dict(t=out.poses_t.numpy(), q=out.poses_q.numpy(), lm=out.landmarks.numpy(),
                             history=np.asarray(info["history"])))
    assert runs[0].keys() == runs[1].keys()
    for k in runs[0]:
        assert np.array_equal(runs[0][k], runs[1][k]), k
    profiling.clear_spans()


def test_span_table_gives_self_time_without_the_children():
    S = profiling.SpanRecord
    spans = [S("child", 2, 1, 0, 0, 1.0, 1.25), S("child", 3, 1, 0, 0, 1.5, 1.75), S("outer", 1, None, 0, 0, 0.5, 2.5)]
    rows = {line.split()[0]: line.split()[1:] for line in profiling.span_table(spans).splitlines()[1:]}
    assert rows == {"outer": ["1", "2000.000", "1500.000"], "child": ["2", "500.000", "500.000"]}
