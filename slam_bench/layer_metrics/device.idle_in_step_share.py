"""Share (%) of the profiled slice's idle device time during which the
main thread was inside the program's `keyframe.step` spans (enqueuing a
step)."""

from slam_bench.layer_metrics._program import idle_in


def read(ctx):
    return idle_in(ctx, "keyframe.step")
