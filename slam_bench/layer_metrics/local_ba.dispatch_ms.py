"""Host ms to enqueue one local-BA solve and its fetch (median of the
program's `local_ba.dispatch` spans in the profiled slice)."""

from slam_bench.layer_metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "local_ba.dispatch")
