"""Host ms per keyframe-making Frontend.observe_image call (median): the
step's enqueue plus the previous keyframe's materialisation."""

from slam_bench.layer_metrics._frontend import span_ms


def read(ctx):
    return span_ms(ctx, "frontend.observe_image.keyframe")
