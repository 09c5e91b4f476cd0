"""Unique Stamps a query sent to the timeline oracle (the program's
counter ``analytics.bfs_levels_at.oracle_stamps``, its change over each
query), the mean over the window's queries."""


def read(run):
    if not run.work or any("oracle_stamps" not in w for w in run.work):
        return None
    return sum(w["oracle_stamps"] for w in run.work) / len(run.work)
