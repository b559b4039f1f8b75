"""Offline BA: device kernels per LM iteration over one profiled solve
(memcpy and memset not counted)."""


def read(ctx):
    rec = ctx.get("slice")
    if ctx.get("kind") != "ba" or rec is None or not ctx["slice_iters"]:
        return None
    return sum(1 for k in rec["kernels"] if k[3] == "kernel") / ctx["slice_iters"]
