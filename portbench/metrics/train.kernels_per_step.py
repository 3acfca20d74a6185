"""Device kernels per train step in the traced epochs (copies not counted):
what a fusion moves."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("steps"):
        return None
    return t["kernels"] / t["steps"]
