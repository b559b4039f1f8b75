"""B3 (hamming_top2) share of its roofline over the slice's keyframes: the
stereo match (K x K, the right image's valid keypoints as trains) and the
window match (W*K x K, the keyframe's stereo survivors as trains)."""

from slam_bench import roofline


def _bound(ctx, r):
    s = ctx["settings"]
    K, W = s["max_features"], s["frame_life"]
    return (roofline.hamming_top2_ms(K, K, 8, r["n_right_valid"])
            + roofline.hamming_top2_ms(W * K, K, 8, r["n"])), 2


def read(ctx):
    if ctx.get("kind") != "frontend":
        return None
    return roofline.share(ctx, "hamming_top2_kernel", _bound)
