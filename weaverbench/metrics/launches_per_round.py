"""Kernels the queries launched in the traced window over the rounds
their answers imply (``work.bfs_rounds`` / ``work.pagerank_rounds``)."""


def read(run):
    if run.trace is None or not run.trace.query_launches:
        return None
    return run.trace.query_launches / sum(w["rounds"] for w in run.work)
