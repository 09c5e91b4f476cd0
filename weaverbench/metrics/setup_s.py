"""Seconds from the process's start to the first timed query: imports,
the card's context, the graph's generation and CSC sort, one warm-up
write window and query."""


def read(run):
    return run.setup_s
