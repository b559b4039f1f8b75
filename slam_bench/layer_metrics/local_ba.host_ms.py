"""Host ms per keyframe of local BA as the frontend CLI drives it (median):
apply the previous solve, build the window, dispatch this one."""

from slam_bench.layer_metrics._frontend import span_ms


def read(ctx):
    return span_ms(ctx, "local_ba")
