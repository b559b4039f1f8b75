"""B2 (extract_patches) share of its roofline over the slice's keyframes:
one float16 plane per image and level, 31x31 patches of that level's
budget of keypoints (the reference's keypoints give the pixels covered)."""

from slam_bench import roofline
from slam_bench.reference.frontend_ref import level_budgets, level_shapes


def _bound(ctx, r):
    s = ctx["settings"]
    H, W = ctx["image_shape"]
    shapes = level_shapes(H, W, s["num_levels"], s["pyramid_scale"], s["detect_border"])
    budgets = level_budgets(s["max_features"], s["num_levels"])
    total = 0.0
    for side in r["levels"]:
        for (h, w, _), k, (kps, _) in zip(shapes, budgets, side):
            covered = roofline.covered_pixels(roofline.patch_starts(kps, 31, h, w), 31, h, w)
            total += roofline.extract_patches_ms(covered, 1, 2, k, 31)
    return total, 2 * s["num_levels"]


def read(ctx):
    if ctx.get("kind") != "frontend" or any("levels" not in ctx["ref_results"][k]
                                            for k in ctx.get("slice_info", {}).get("keyframes", [])
                                            if k < len(ctx["ref_results"])):
        return None
    return roofline.share(ctx, "extract_patches_kernel", _bound)
