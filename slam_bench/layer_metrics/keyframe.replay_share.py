"""Share (%) of the program's `keyframe.step` spans in the profiled slice
that hold a `keyframe.replay` span: keyframes whose step was one replay of
a captured CUDA graph. None where the slice holds no replay span (a program
that records none, a run without `--trace 1`)."""

from slam_bench.layer_metrics._program import spans_in


def read(ctx):
    steps, replays = spans_in(ctx, "keyframe.step"), spans_in(ctx, "keyframe.replay")
    if steps is None or replays is None:
        return None
    inner = [(a, b) for a, b, _, _ in replays[1]]
    held = sum(1 for a, b, _, _ in steps[1] if any(a <= c and d <= b for c, d in inner))
    return 100.0 * held / len(steps[1])
