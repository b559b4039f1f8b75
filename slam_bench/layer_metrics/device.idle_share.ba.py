"""Share (%) of one profiled BA solve with nothing running on the device."""


def read(ctx):
    rec = ctx.get("slice")
    if ctx.get("kind") != "ba" or rec is None or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
