"""The share of the traced training window in which no operation ran on the
card, from the union of the profiler's device intervals."""

from gpubench import trace


def read(run):
    return trace.idle_share(run) if "steps" in run.record else None
