"""Queries completed in the window over the window's seconds (host
clock): the window holds every write window and query it ran."""


def read(run):
    return len(run.latencies_s) / run.window_s
