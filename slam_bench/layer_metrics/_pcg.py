"""What the readers of the pose-major PCG route share: the program's
counters (vision_slam_frontend_tpu_torch.utils.profiling.count, recorded
only while a torch.profiler records) inside the PCG slice (ctx["pcg_slice"],
slam_bench/drivers/ba_offline_pcg.PcgSlice), and the launch calls and
kernels inside the program's `ba.pcg` spans there. The spans are taken as
that trace holds them (`annotations`: the host side of record_function,
which each span enters), on the trace's own clock, as the launch calls
are: no map from the host's clock is involved. Each returns None where
there is nothing to read: a run without `--trace 1`, a CPU run, or a
program that records no such counter or span."""

from __future__ import annotations


def counters_in(ctx: dict, name: str) -> list:
    """(value, request) of the counters `name` recorded on the run's main
    thread while the PCG slice recorded (host clock)."""
    from vision_slam_frontend_tpu_torch.utils import profiling

    rec = ctx.get("pcg_slice")
    read = getattr(profiling, "recorded_counters", None)
    if rec is None or read is None:
        return []
    return [(c.value, c.request) for c in read()
            if c.name == name and c.thread == ctx.get("main_thread") and rec["host0"] <= c.t <= rec["host1"]]


def pcg_ranges(ctx: dict):
    """(slice record, [(start, end)] of the trace's `ba.pcg` ranges, one an
    LM iteration), or None where the trace holds none."""
    rec = ctx.get("pcg_slice")
    ranges = (rec or {}).get("annotations", {}).get("ba.pcg", [])
    return (rec, ranges) if ranges else None


def pcg_launches_per_iter(ctx: dict):
    """Launch calls inside the `ba.pcg` ranges over the ranges."""
    got = pcg_ranges(ctx)
    if got is None:
        return None
    rec, ranges = got
    return sum(1 for t in rec["launches"] if any(a <= t <= b for a, b in ranges)) / len(ranges)


def cg_iter_ms(ctx: dict):
    """Device ms of the kernels whose launch call lies inside the `ba.pcg`
    ranges, over the CG iterations they ran (the `ba.cg_iterations`
    counters, one per range: where the two counts differ, None)."""
    got = pcg_ranges(ctx)
    if got is None or "kernel_launches" not in got[0]:
        return None
    rec, ranges = got
    iterations = [v for v, _ in counters_in(ctx, "ba.cg_iterations")]
    ms = sum(d for t, d in rec["kernel_launches"] if any(a <= t <= b for a, b in ranges)) * 1e3
    if len(iterations) != len(ranges) or sum(iterations) <= 0 or ms <= 0:
        return None
    return ms / sum(iterations)
