"""Device ms of the kernels launched inside the program's `ba.pcg` spans in
the profiled solve, over the CG iterations they ran."""

from slam_bench.layer_metrics._pcg import cg_iter_ms


def read(ctx):
    return cg_iter_ms(ctx)
