"""Device busy milliseconds per train step in the traced epochs."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("steps"):
        return None
    return t["busy_s"] * 1e3 / t["steps"]
