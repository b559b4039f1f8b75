"""Median over the profiled solve's LM iterations of the program's
`ba.cg_residual_rel` counter: |r| / |b| of the reduced camera system after
the truncated conjugate gradients."""

import statistics

from slam_bench.layer_metrics._pcg import counters_in


def read(ctx):
    values = [v for v, _ in counters_in(ctx, "ba.cg_residual_rel")]
    return statistics.median(values) if values else None
