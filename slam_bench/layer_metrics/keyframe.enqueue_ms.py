"""Host ms to enqueue one keyframe step (median of the program's
`keyframe.step` spans in the profiled slice): launches only, no sync."""

from slam_bench.layer_metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "keyframe.step")
