"""Kernel-launch calls per LM iteration made inside the program's `ba.pcg`
spans (the pose-major route's conjugate-gradient loop) in the profiled
solve, the spans as the trace holds them."""

from slam_bench.layer_metrics._pcg import pcg_launches_per_iter


def read(ctx):
    return pcg_launches_per_iter(ctx)
