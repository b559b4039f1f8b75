"""CPU tests of the readers of the program's own spans
(slam_bench/layer_metrics/_program.py and the readers built on it), on a
slice record made from hand-written trace events with a known host-to-trace
map, and hand-written program spans (`python -m pytest slam_bench -q`)."""

from __future__ import annotations

import pytest

from slam_bench import common, devtrace
from slam_bench.layer_metrics import _program

MAIN, OTHER = 1, 2
READERS = ["keyframe.enqueue_ms", "keyframe.extract_launches", "frontend.flush_wait_ms", "frontend.accumulate_ms",
           "device.idle_in_step_share", "input.wait_ms", "local_ba.build_ms", "local_ba.dispatch_ms",
           "ba.sync_wait_ms", "ba.assemble_launches_per_iter"]


def _x(name, cat, ts_s, dur_s=0.0):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts_s * 1e6, "dur": dur_s * 1e6}


HOST0, HOST1, CLOSE = 8.9957, 11.0, 2.99995


def _slice():
    """Markers start on the device at 1.0 and 3.0 s of the trace; the host
    read 8.9957 s before the first (whose launch lagged 4.3 ms) and 11.0 s
    before the second, whose launch call is at 2.99995: host = 11.0 +
    (trace - 2.99995). Device busy [1.2, 1.4] and [2.0, 2.6], so the idle
    gaps are [1.0, 1.2], [1.4, 2.0], [2.6, 3.0] (1.2 s). Launch calls at
    1.1, 1.3, 1.5, 2.1, 2.401, 2.9, and one at 0.5, before the first
    marker."""
    events = [_x(devtrace.MARKER, "kernel", 1.0, 1e-9), _x(devtrace.MARKER, "kernel", 3.0, 1e-9),
              _x("k_a", "kernel", 1.2, 0.2), _x("k_b", "kernel", 2.0, 0.3), _x("copy", "gpu_memcpy", 2.3, 0.3)]
    events += [_x("cudaLaunchKernel", "cuda_runtime", t) for t in (0.5, 1.1, 1.3, 1.5, 2.1, 2.401, 2.9, CLOSE)]
    return devtrace.read_events(events, HOST0, HOST1)


def _host(trace_s):
    return HOST1 + (trace_s - CLOSE)


def _span(name, a, b, request=None, thread=MAIN, sid=0):
    """A SpanRecord-shaped tuple from trace-clock start and end."""
    return (name, sid, None, thread, request, _host(a), _host(b))


SPANS = [
    _span("keyframe.step", 1.4, 1.9, 7), _span("keyframe.step", 2.0, 2.2, 8),
    _span("keyframe.step", 0.6, 0.9, 6),  # before the slice
    _span("keyframe.step", 1.0, 2.9, 9, thread=OTHER),  # another thread
    _span("keyframe.extract", 1.05, 1.15, 7), _span("keyframe.extract", 1.2, 1.4, 7),
    _span("keyframe.extract", 2.7, 2.8, 8),
    _span("ba.assemble", 1.0, 1.6, (0, 0)), _span("ba.assemble", 2.0, 2.15, (0, 1)),
    _span("ba.sync", 2.2, 2.4, (0, 1)),
    _span("input.wait", 1.0, 1.2), _span("input.wait", 2.6, 2.95), _span("input.wait", 1.4, 1.5, thread=OTHER),
]


@pytest.fixture
def ctx(monkeypatch):
    monkeypatch.setattr(_program, "recorded", lambda: list(SPANS))
    return dict(kind="frontend", slice=_slice(), main_thread=MAIN, slice_info=dict(frame0=10, frame1=14))


def test_span_ms_is_the_median_host_duration_in_the_slice(ctx):
    # 0.5 s and 0.2 s of host time; the span before the slice and the other thread's are left out.
    assert _program.span_ms(ctx, "keyframe.step") == pytest.approx(350.0)
    assert _program.total_ms(ctx, "input.wait") == pytest.approx(550.0)
    assert _program.span_ms(ctx, "frontend.accumulate") is None


def test_launches_in_counts_launch_calls_per_request(ctx):
    # Keyframe 7's two extracts hold the calls at 1.1 and 1.3; keyframe 8's none: 2 over 2 keyframes.
    assert _program.launches_in(ctx, "keyframe.extract") == pytest.approx(1.0)
    # Iteration (0, 0) holds 1.1, 1.3, 1.5; (0, 1) holds 2.1: 4 over 2 iterations.
    assert _program.launches_in(ctx, "ba.assemble") == pytest.approx(2.0)


def test_the_map_anchors_on_the_closing_markers_launch(ctx):
    """The sync span ends 1 ms before the launch at 2.401 and holds none.
    Mapped through the markers' device starts (the slice's trace_of), the
    first marker's lagging launch moves it 1.3 ms late, onto that launch."""
    assert _program.launches_in(ctx, "ba.sync") == 0.0
    rec = ctx["slice"]
    assert rec["trace_of"](_host(2.4)) > 2.401


def test_idle_in_is_the_share_of_idle_time_inside_the_spans(ctx):
    # [1.4, 1.9] lies in the gap [1.4, 2.0]; [2.0, 2.2] in busy time: 0.5 of 1.2 s idle.
    assert _program.idle_in(ctx, "keyframe.step") == pytest.approx(100.0 * 0.5 / 1.2)
    assert _program.idle_in(ctx, "input.wait") == pytest.approx(100.0 * 0.55 / 1.2)


def test_spans_outside_the_markers_or_on_another_thread_are_ignored(ctx, monkeypatch):
    monkeypatch.setattr(_program, "recorded", lambda: [_span("keyframe.step", 0.6, 0.9, 6),
                                                       _span("keyframe.step", 0.99, 1.1, 6),
                                                       _span("keyframe.step", 2.9, 3.2, 6),
                                                       _span("keyframe.step", 1.5, 1.7, 9, thread=OTHER)])
    for helper in (_program.span_ms, _program.total_ms, _program.launches_in, _program.idle_in):
        assert helper(ctx, "keyframe.step") is None


def test_the_readers_read_their_spans(ctx):
    read = {name: common.load_module(common.BENCH_DIR, "layer_metrics", name).read for name in READERS}
    assert read["keyframe.enqueue_ms"](ctx) == pytest.approx(350.0)
    assert read["keyframe.extract_launches"](ctx) == pytest.approx(1.0)
    assert read["device.idle_in_step_share"](ctx) == pytest.approx(100.0 * 0.5 / 1.2)
    assert read["input.wait_ms"](ctx) == pytest.approx(550.0 / 4)  # four stereo frames in the slice
    assert read["ba.sync_wait_ms"](ctx) == pytest.approx(200.0)
    assert read["ba.assemble_launches_per_iter"](ctx) == pytest.approx(2.0)


@pytest.mark.parametrize("name", READERS)
def test_every_reader_reads_nothing_without_program_spans(monkeypatch, name):
    reader = common.load_module(common.BENCH_DIR, "layer_metrics", name).read
    base = dict(kind="frontend", main_thread=MAIN, slice_info=dict(frame0=10, frame1=14))
    assert reader(dict(base, slice=None)) is None  # a run without --trace 1, or on the CPU
    monkeypatch.setattr(_program, "recorded", lambda: [])
    assert reader(dict(base, slice=_slice())) is None  # a program that records no span
    monkeypatch.setattr(_program, "recorded", lambda: [_span("unread.span", 1.2, 1.4, 1)])
    assert reader(dict(base, kind="ba", slice=_slice())) is None
