"""Offline BA: the window's solve time over the LM iterations its solves
ran, in ms."""


def read(ctx):
    if ctx.get("kind") != "ba" or not ctx["iterations"]:
        return None
    return ctx["window_s"] * 1e3 / ctx["iterations"]
