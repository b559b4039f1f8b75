"""CPU tests of the `keyframe.replay_share` reader on the hand-written slice
and spans of test_slam_bench_program_spans.py (`python -m pytest slam_bench
-q`)."""

from __future__ import annotations

import pytest

from slam_bench import common
from slam_bench.layer_metrics import _program
from slam_bench.test_slam_bench_program_spans import MAIN, OTHER, _slice, _span


def _read(ctx):
    return common.load_module(common.BENCH_DIR, "layer_metrics", "keyframe.replay_share").read(ctx)


@pytest.fixture
def ctx():
    return dict(kind="frontend", slice=_slice(), main_thread=MAIN, slice_info=dict(frame0=10, frame1=14))


def test_every_step_holding_a_replay_reads_100(ctx, monkeypatch):
    monkeypatch.setattr(_program, "recorded", lambda: [
        _span("keyframe.step", 1.4, 1.9, 7), _span("keyframe.replay", 1.5, 1.8, 7),
        _span("keyframe.step", 2.0, 2.2, 8), _span("keyframe.capture", 2.01, 2.1, 8),
        _span("keyframe.replay", 2.1, 2.15, 8)])
    assert _read(ctx) == pytest.approx(100.0)


def test_a_step_without_a_replay_halves_the_share(ctx, monkeypatch):
    """Keyframe 8 stepped eagerly; the replay on another thread and the one
    outside the slice hold no step of the main thread."""
    monkeypatch.setattr(_program, "recorded", lambda: [
        _span("keyframe.step", 1.4, 1.9, 7), _span("keyframe.replay", 1.5, 1.8, 7),
        _span("keyframe.step", 2.0, 2.2, 8), _span("keyframe.replay", 2.05, 2.1, 8, thread=OTHER),
        _span("keyframe.replay", 0.6, 0.7, 6)])
    assert _read(ctx) == pytest.approx(50.0)


def test_no_spans_read_none(ctx, monkeypatch):
    monkeypatch.setattr(_program, "recorded", lambda: [])
    assert _read(ctx) is None
    # Steps but no replay: a program that records no such span (the eager step).
    monkeypatch.setattr(_program, "recorded", lambda: [_span("keyframe.step", 1.4, 1.9, 7)])
    assert _read(ctx) is None
    assert _read(dict(ctx, slice=None)) is None
