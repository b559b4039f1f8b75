"""Kernel-launch calls per LM iteration made inside the program's
`ba.assemble` spans (the Schur terms, or the dense assembly and its
coupling) in the profiled solve."""

from slam_bench.layer_metrics._program import launches_in


def read(ctx):
    return launches_in(ctx, "ba.assemble")
