"""Device-busy ms per keyframe in the profiled slice (the union of kernel,
memcpy and memset intervals)."""

from slam_bench.layer_metrics._frontend import slice_keyframes


def read(ctx):
    s = slice_keyframes(ctx)
    if s is None:
        return None
    rec, n = s
    return rec["busy_s"] * 1e3 / n
