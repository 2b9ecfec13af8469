"""partition_s: the mean wall time of the window's jobs, each from the call
into `run_partitioner` to its labels on the host (host clock)."""


def read(run):
    if not run.jobs:
        return None
    return sum(j.wall_s for j in run.jobs) / len(run.jobs)
