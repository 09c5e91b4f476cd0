"""Traversed edges per second of device time: the input edges each BFS
traversed (``work.bfs_traversed_edges``: Graph500's count of edge
tuples, each undirected edge once), summed over the traced window's
queries, over the queries' device time (not Graph500's wall time of a
search, so the figure reads higher than a Graph500 result would)."""


def read(run):
    if (run.trace is None or not run.trace.query_device_s
            or any("traversed_edges" not in w for w in run.work)):
        return None
    return (sum(w["traversed_edges"] for w in run.work)
            / run.trace.query_device_s)
