"""The share of the traced jobs' time in which no operation ran on the
device."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("gestures"):
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
