"""max_norm_load: the mean over the window's jobs of the largest part's
out-degree load over |E| / k, as the reference recounts it."""


def read(run):
    vals = [j.max_norm_load for j in run.jobs if j.max_norm_load is not None]
    return sum(vals) / len(vals) if vals else None
