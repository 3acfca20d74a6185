"""The share of the traced epochs in which no operation ran on the device
(busy time is the union of the device operations' intervals)."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("steps"):
        return None
    return 1.0 - t["busy_s"] / t["window_s"]
