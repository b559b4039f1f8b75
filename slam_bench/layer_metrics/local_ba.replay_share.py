"""Share (%) of the program's `local_ba.dispatch` spans in the profiled
slice that hold a `local_ba.replay` span: local solves dispatched as one
replay of their capacity bucket's captured CUDA graph. None where the slice
holds no replay span (a program that records none, a run without
`--trace 1`)."""

from slam_bench.layer_metrics._program import spans_in


def read(ctx):
    dispatches, replays = spans_in(ctx, "local_ba.dispatch"), spans_in(ctx, "local_ba.replay")
    if dispatches is None or replays is None:
        return None
    inner = [(a, b) for a, b, _, _ in replays[1]]
    held = sum(1 for a, b, _, _ in dispatches[1] if any(a <= c and d <= b for c, d in inner))
    return 100.0 * held / len(dispatches[1])
