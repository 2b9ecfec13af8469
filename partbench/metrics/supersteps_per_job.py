"""supersteps_per_job: the mean `PartitionResult.steps` of the window's jobs."""


def read(run):
    if not run.jobs:
        return None
    return sum(j.steps for j in run.jobs) / len(run.jobs)
