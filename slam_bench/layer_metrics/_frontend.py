"""What the frontend cells' readers share: host spans of the window, and
the profiled slice's per-keyframe figures."""

from __future__ import annotations

import statistics


def span_ms(ctx: dict, name: str):
    """Median ms of the spans `name` in the window (the profiled slice
    follows it); None when there are none."""
    if ctx.get("kind") != "frontend":
        return None
    d = ctx["spans"].durations(name, ctx["t_start"], ctx["t_end"])
    return statistics.median(d) * 1e3 if d else None


def slice_keyframes(ctx: dict):
    """(slice record, keyframes launched in it), or None."""
    rec, info = ctx.get("slice"), ctx.get("slice_info", {})
    if ctx.get("kind") != "frontend" or rec is None or not info.get("keyframes"):
        return None
    return rec, len(info["keyframes"])
