"""Device kernels per keyframe in the profiled slice (memcpy and memset not
counted)."""

from slam_bench.layer_metrics._frontend import slice_keyframes


def read(ctx):
    s = slice_keyframes(ctx)
    if s is None:
        return None
    rec, n = s
    return sum(1 for k in rec["kernels"] if k[3] == "kernel") / n
