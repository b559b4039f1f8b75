"""Host ms to turn one fetched keyframe into problem entries (median of
the program's `frontend.accumulate` spans in the profiled slice)."""

from slam_bench.layer_metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "frontend.accumulate")
