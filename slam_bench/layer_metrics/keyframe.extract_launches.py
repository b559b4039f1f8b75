"""Kernel-launch calls per keyframe made inside the program's
`keyframe.extract` spans (both images: pyramid, FAST, describe per level)
in the profiled slice."""

from slam_bench.layer_metrics._program import launches_in


def read(ctx):
    return launches_in(ctx, "keyframe.extract")
