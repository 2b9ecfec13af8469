"""superstep_ms: the window's job wall time over its supersteps, in ms
(untraced jobs, each ending with its labels on the host)."""


def read(run):
    steps = sum(j.steps for j in run.jobs)
    if not steps:
        return None
    return 1e3 * sum(j.wall_s for j in run.jobs) / steps
