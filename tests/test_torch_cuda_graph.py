"""utils/cuda_graph.CapturedCall, the one capture-and-replay policy of the
port's CUDA graphs, on the CPU: driven through each of its two owners (the
Frontend's keyframe step graph, layer `keyframe`, and the local-BA solve
graph, layer `local_ba`) with torch's CUDA graph swapped for a fake that
records what is done with it. The card tests hold each replay to the eager
call bit for bit (tests/test_torch_cuda.py -k graph, tests/test_torch_local_ba.py
-k graph)."""

import contextlib
import types

import pytest

torch = pytest.importorskip("torch")

from vision_slam_frontend_tpu_torch.backend import local_ba as lba  # noqa: E402
from vision_slam_frontend_tpu_torch.frontend.frontend import _StepGraph  # noqa: E402
from vision_slam_frontend_tpu_torch.io.synthetic import synthetic_ba_problem  # noqa: E402
from vision_slam_frontend_tpu_torch.ops import cuda_kernels as ck  # noqa: E402
from vision_slam_frontend_tpu_torch.utils import profiling  # noqa: E402

CPU = torch.device("cpu")
LAYERS = ["keyframe", "local_ba"]
# The hand-written kernel calls the fake step records while it is captured.
STEP_KERNELS = {"fast_scores_nms": 2, "hamming_top2": 1}


@pytest.fixture
def fake(monkeypatch):
    """torch.cuda's graph and capture context swapped for fakes that log
    each capture and replay; launch counts reset before and after."""
    log = []
    state = types.SimpleNamespace(log=log, capturing=False)

    class FakeGraph:
        def replay(self):
            log.append("replay")

    @contextlib.contextmanager
    def capture(graph, capture_error_mode=None):
        assert isinstance(graph, FakeGraph) and capture_error_mode == "thread_local"
        log.append("capture")
        state.capturing = True
        try:
            yield
        finally:
            state.capturing = False
            log.append("captured")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", capture)
    ck.reset_launch_counts()
    yield state
    ck.reset_launch_counts()


def _owner(layer, fake, monkeypatch):
    """(call(request) -> result, the owner's CapturedCall) for `layer`, its
    device work a fake step that logs whether it ran captured and, when
    captured, records STEP_KERNELS into cuda_kernels.CAPTURED."""

    def step(*_):
        fake.log.append(("step", fake.capturing))
        if fake.capturing:
            for k, n in STEP_KERNELS.items():
                ck.CAPTURED[k] += n
        return object()

    if layer == "keyframe":
        graph = _StepGraph(CPU, (6, 8))
        return (lambda request: graph.run(step, request)), graph.call
    monkeypatch.setattr(lba, "_solve_window", step)
    _, prob, _, _ = synthetic_ba_problem(P=4, L=20, seed=0, stereo=True, gather_tables=False, device=CPU)
    padded = lba._pad_ba_for_device(prob.to_numpy(), n_poses=4)
    graph = lba._SolveGraph(padded, CPU)
    graph.upload(padded)
    return (lambda request: graph.run(None, request)), graph.call


@pytest.mark.parametrize("layer", LAYERS)
def test_the_first_call_is_eager_the_second_captured_and_every_later_one_replayed(fake, monkeypatch, layer):
    call, captured = _owner(layer, fake, monkeypatch)
    eager = call(7)
    assert fake.log == [("step", False)] and captured.graph is None
    out = call(8)
    assert fake.log[1:] == ["capture", ("step", True), "captured", "replay"]
    assert out is captured.result is not eager
    assert call(9) is out and call(10) is out
    assert fake.log[5:] == ["replay", "replay"]
    assert captured.replays == 3


@pytest.mark.parametrize("layer", LAYERS)
def test_capture_and_replay_spans_name_the_layer_and_carry_the_request(fake, monkeypatch, layer):
    from torch.profiler import ProfilerActivity, profile

    call, _ = _owner(layer, fake, monkeypatch)
    profiling.clear_spans()
    call(7)
    assert profiling.recorded_spans() == []  # nothing is recorded while no profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        call(8)
        call(9)
    spans = profiling.recorded_spans()
    profiling.clear_spans()
    assert [(s.name, s.request) for s in spans] == [
        (f"{layer}.capture", 8), (f"{layer}.replay", 8), (f"{layer}.replay", 9)]
    assert all(s.parent is None for s in spans)  # siblings under the caller's span, never nested


@pytest.mark.parametrize("layer", LAYERS)
def test_each_replay_adds_the_captured_kernels_to_replayed(fake, monkeypatch, layer):
    call, captured = _owner(layer, fake, monkeypatch)
    call(7)
    assert ck.CAPTURED == ck.REPLAYED == dict.fromkeys(ck.LAUNCHES, 0)
    for replays in (1, 2, 3):
        call(7 + replays)
        assert captured.replays == replays and captured.kernels == STEP_KERNELS
        assert ck.CAPTURED == {k: STEP_KERNELS.get(k, 0) for k in ck.LAUNCHES}
        assert ck.REPLAYED == {k: replays * STEP_KERNELS.get(k, 0) for k in ck.LAUNCHES}
    assert ck.runs() == ck.REPLAYED and sum(ck.LAUNCHES.values()) == 0
