"""Gestures returned to the host per second over the whole window."""

from portbench.stats import rate


def read(ctx):
    w = ctx["window"]
    return rate(w["gestures"], w["window_s"]) if "jobs" in w else None
