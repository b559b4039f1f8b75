"""Host ms per LM iteration spent fetching the candidate's cost, the
iteration's one sync (median of the program's `ba.sync` spans in the
profiled solve)."""

from slam_bench.layer_metrics._program import span_ms


def read(ctx):
    return span_ms(ctx, "ba.sync")
