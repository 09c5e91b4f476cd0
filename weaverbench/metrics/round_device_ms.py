"""Device time of the queries' operations in the traced window over the
rounds their answers imply, in ms."""


def read(run):
    if run.trace is None or not run.trace.query_device_s:
        return None
    return run.trace.query_device_s / sum(w["rounds"] for w in run.work) * 1e3
