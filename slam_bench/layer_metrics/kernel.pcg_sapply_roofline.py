"""Share (%) of one CG iteration's byte bound (slam_bench/roofline_pcg, from
the problem's shapes) over `ba.cg_iter_ms`, the device ms of an iteration's
kernels."""

from slam_bench import roofline_pcg
from slam_bench.layer_metrics._pcg import cg_iter_ms


def read(ctx):
    shapes = ctx.get("pcg")
    ms = cg_iter_ms(ctx)
    if shapes is None or ms is None:
        return None
    bound = roofline_pcg.cg_iteration_ms(shapes["P"], shapes["Mp"], shapes["L"], shapes["Ml"], shapes["rows"])
    return 100.0 * bound / ms
