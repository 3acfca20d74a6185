"""The 95th percentile (nearest rank) of the latency of every job of the
window, from its call to its numpy result in hand."""

from portbench.stats import percentile


def read(ctx):
    w = ctx["window"]
    return percentile(w["job_ms"], 95) if "jobs" in w else None
