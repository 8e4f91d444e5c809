"""The share of the traced serving window in which no operation ran on the
card, from the union of the profiler's device intervals."""

from gpubench import trace


def read(run):
    return trace.idle_share(run) if "served" in run.record else None
