"""device_idle: the share of a job's untraced wall time in which no device
operation ran, in %: 1 - the union of device spans over the profiled jobs
(the window's first jobs, run again under the profiler) over the wall
those same jobs took in the untraced window. The profiler slows the host,
not the kernels, so its own wall would count its overhead as idle."""


def read(run):
    p = run.profile
    if p is None or not p.device_ops or p.untraced_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.untraced_s)
