"""Host ms to build one local-BA window (median of the program's
`local_ba.build` spans in the profiled slice: slice the problem, its
tracks, padding, upload)."""

from slam_bench.layer_metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "local_ba.build")
