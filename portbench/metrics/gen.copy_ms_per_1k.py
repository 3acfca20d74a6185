"""Device milliseconds of host-device copies per 1,000 gestures, in the
traced jobs."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("gestures") or not t["copy_s"]:
        return None
    return t["copy_s"] * 1e3 / (t["gestures"] / 1e3)
