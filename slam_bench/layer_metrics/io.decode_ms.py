"""Host ms per stereo pair read and decoded on the prefetch thread (median
of the `io.decode` spans around iter_euroc_events' stereo events)."""

from slam_bench.layer_metrics._frontend import span_ms


def read(ctx):
    return span_ms(ctx, "io.decode")
