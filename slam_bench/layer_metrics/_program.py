"""What the readers of the program's own spans share. The port records a
span (vision_slam_frontend_tpu_torch.utils.profiling.span: name, id, parent,
thread, request, host start and end on time.perf_counter) only while a
torch.profiler records, so its spans cover the profiled slice. Each helper
takes the spans of one name that lie between the slice's markers (on the
host's clock) on the run's main thread, mapped onto the trace's clock, and
returns None where there are none: a run without `--trace 1`, a CPU run,
or a program that records no such span.

The map anchors on the closing marker's launch call, the slice's last
launch: it follows the host's `time.perf_counter()` reading at once, and
the trace's host-side clock runs at the host's rate. The slice's own
`trace_of` anchors on the markers' device starts instead, and the first
marker's launch, the first after the profiler starts, lags the host by
milliseconds (4.3 ms on the H100): that map puts a span early in the slice
late, onto the launches of the span after it."""

from __future__ import annotations

import statistics


def recorded() -> list:
    """The program's recorded spans as (name, id, parent, thread, request,
    start, end) tuples, or [] where it records none."""
    from vision_slam_frontend_tpu_torch.utils import profiling

    read = getattr(profiling, "recorded_spans", None)
    return list(read()) if read is not None else []


def spans_in(ctx: dict, name: str, thread: int | None = None):
    """(slice record, [(start, end, duration s, request)] of the spans
    `name` on `thread` (the main thread by default) inside the slice, start
    and end on the trace's clock), or None where there are none."""
    rec = ctx.get("slice")
    if rec is None or not rec["launches"]:
        return None
    tid = ctx.get("main_thread") if thread is None else thread
    host0, host1, last = rec["host_of"](rec["m0"]), rec["host_of"](rec["m1"]), rec["launches"][-1]
    out = [(last + (s[5] - host1), last + (s[6] - host1), s[6] - s[5], s[4]) for s in recorded()
           if s[0] == name and s[3] == tid and host0 <= s[5] and s[6] <= host1]
    return (rec, out) if out else None


def span_ms(ctx: dict, name: str):
    """Median host ms of the spans `name` in the slice."""
    got = spans_in(ctx, name)
    return None if got is None else statistics.median(d for _, _, d, _ in got[1]) * 1e3


def total_ms(ctx: dict, name: str):
    """Summed host ms of the spans `name` in the slice."""
    got = spans_in(ctx, name)
    return None if got is None else sum(d for _, _, d, _ in got[1]) * 1e3


def launches_in(ctx: dict, name: str):
    """The slice's kernel-launch calls made inside the spans `name`, per
    request (a keyframe, an LM iteration): over the distinct requests of
    those spans."""
    got = spans_in(ctx, name)
    if got is None or not got[0]["launches"]:
        return None
    rec, spans = got
    n = sum(1 for t in rec["launches"] if any(a <= t <= b for a, b, _, _ in spans))
    return n / len({r for _, _, _, r in spans})


def idle_in(ctx: dict, name: str):
    """Share (%) of the slice's idle device time that falls inside the
    spans `name`: the gaps between the merged device intervals, from the
    first marker to the last, intersected with the spans' union."""
    got = spans_in(ctx, name)
    if got is None:
        return None
    rec, spans = got
    edges = [rec["m0"]] + [x for ab in rec["intervals"] for x in ab] + [rec["m1"]]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    idle = sum(b - a for a, b in gaps)
    if idle <= 0:
        return None
    union = []
    for a, b, _, _ in sorted(spans):
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    inside = sum(max(0.0, min(b, d) - max(a, c)) for a, b in gaps for c, d in union)
    return 100.0 * inside / idle
