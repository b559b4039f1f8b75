"""B1 (fast_scores_nms) share of its roofline over the slice's keyframes:
both images at every pyramid level, level 0 uint8, the rest float32."""

from slam_bench import roofline
from slam_bench.reference.frontend_ref import level_shapes


def _bound(ctx, r):
    s = ctx["settings"]
    H, W = ctx["image_shape"]
    total = 0.0
    for i, (h, w, _) in enumerate(level_shapes(H, W, s["num_levels"], s["pyramid_scale"], s["detect_border"])):
        total += 2 * roofline.fast_nms_ms(h, w, 1 if i == 0 else 4)
    return total, 2 * s["num_levels"]


def read(ctx):
    if ctx.get("kind") != "frontend":
        return None
    return roofline.share(ctx, "fast_nms_kernel", _bound)
