"""Host ms the main thread waits on the decode-ahead queue per stereo
frame: the program's `input.wait` spans in the profiled slice, summed, over
the stereo frames taken in the slice."""

from slam_bench.layer_metrics._program import total_ms


def read(ctx):
    info = ctx.get("slice_info", {})
    frames = info.get("frame1", 0) - info.get("frame0", 0)
    total = total_ms(ctx, "input.wait")
    return None if total is None or frames <= 0 else total / frames
