"""Kernel launches per local solve: the host's launch calls, in the
profiled slice, made inside the `local_ba` spans (apply, window build,
dispatch), over the spans there."""


def read(ctx):
    rec = ctx.get("slice")
    if ctx.get("kind") != "frontend" or rec is None or not rec["launches"]:
        return None
    spans = [(rec["trace_of"](a), rec["trace_of"](b)) for n, tid, a, b in ctx["spans"].items
             if n == "local_ba" and tid == ctx["main_thread"]]
    spans = [(a, b) for a, b in spans if rec["m0"] <= a and b <= rec["m1"]]
    if not spans:
        return None
    return sum(1 for t in rec["launches"] if any(a <= t <= b for a, b in spans)) / len(spans)
