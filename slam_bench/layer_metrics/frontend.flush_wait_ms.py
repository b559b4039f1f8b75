"""Host ms the frontend waits on the previous keyframe's fetch event
(median of the program's `frontend.flush.wait` spans in the profiled
slice)."""

from slam_bench.layer_metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "frontend.flush.wait")
