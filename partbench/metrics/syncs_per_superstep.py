"""syncs_per_superstep: the port tracer's ``device-sync`` spans (blocking
fetches) over its ``superstep`` spans, in the profiled jobs."""


def read(run):
    p = run.profile
    if p is None or not p.spans.get("superstep"):
        return None
    return p.spans.get("device-sync", 0) / p.spans["superstep"]
