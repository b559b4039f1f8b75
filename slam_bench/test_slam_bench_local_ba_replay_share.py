"""CPU tests of the `local_ba.replay_share` reader on the hand-written slice
and spans of test_slam_bench_program_spans.py (`python -m pytest slam_bench
-q`)."""

from __future__ import annotations

import pytest

from slam_bench import common
from slam_bench.layer_metrics import _program
from slam_bench.test_slam_bench_program_spans import MAIN, OTHER, _slice, _span


def _read(ctx):
    return common.load_module(common.BENCH_DIR, "layer_metrics", "local_ba.replay_share").read(ctx)


@pytest.fixture
def ctx():
    return dict(kind="frontend", slice=_slice(), main_thread=MAIN, slice_info=dict(frame0=10, frame1=14))


def test_every_dispatch_holding_a_replay_reads_100(ctx, monkeypatch):
    monkeypatch.setattr(_program, "recorded", lambda: [
        _span("local_ba.dispatch", 1.4, 1.9, 7), _span("local_ba.replay", 1.5, 1.8, 7),
        _span("local_ba.dispatch", 2.0, 2.2, 8), _span("local_ba.replay", 2.05, 2.15, 8)])
    assert _read(ctx) == pytest.approx(100.0)


def test_a_capture_then_its_replay_counts_as_a_replay(ctx, monkeypatch):
    """A bucket's second window is captured, then replayed inside the same
    dispatch; an eager dispatch (a bucket's first window) holds neither."""
    monkeypatch.setattr(_program, "recorded", lambda: [
        _span("local_ba.dispatch", 1.4, 1.9, 7), _span("local_ba.capture", 1.41, 1.7, 7),
        _span("local_ba.replay", 1.7, 1.8, 7),
        _span("local_ba.dispatch", 2.0, 2.2, 8)])
    assert _read(ctx) == pytest.approx(50.0)


def test_a_dispatch_without_a_replay_halves_the_share(ctx, monkeypatch):
    """Keyframe 8's solve dispatched eagerly; the replay on another thread
    and the one outside the slice hold no dispatch of the main thread."""
    monkeypatch.setattr(_program, "recorded", lambda: [
        _span("local_ba.dispatch", 1.4, 1.9, 7), _span("local_ba.replay", 1.5, 1.8, 7),
        _span("local_ba.dispatch", 2.0, 2.2, 8), _span("local_ba.replay", 2.05, 2.1, 8, thread=OTHER),
        _span("local_ba.replay", 0.6, 0.7, 6)])
    assert _read(ctx) == pytest.approx(50.0)


def test_no_spans_read_none(ctx, monkeypatch):
    monkeypatch.setattr(_program, "recorded", lambda: [])
    assert _read(ctx) is None
    # Dispatches but no replay: every solve eager, or a program that records
    # no such span (one without the solve's graphs).
    monkeypatch.setattr(_program, "recorded", lambda: [
        _span("local_ba.dispatch", 1.4, 1.9, 7), _span("local_ba.dispatch", 2.0, 2.2, 8),
        _span("local_ba.replay", 2.05, 2.1, 8, thread=OTHER), _span("local_ba.replay", 0.6, 0.7, 6)])
    assert _read(ctx) is None
    assert _read(dict(ctx, slice=None)) is None
