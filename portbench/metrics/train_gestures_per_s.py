"""Gestures trained per second over the whole window: every gesture of its
epochs over all of its time, epoch boundaries included."""

from portbench.stats import rate


def read(ctx):
    w = ctx["window"]
    return rate(w["gestures"], w["window_s"]) if "epochs" in w else None
