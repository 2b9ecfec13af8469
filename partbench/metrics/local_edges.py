"""local_edges: the mean over the window's jobs of the share of directed
edges inside a part, as the reference recounts it from each job's labels."""


def read(run):
    vals = [j.local_edges for j in run.jobs if j.local_edges is not None]
    return sum(vals) / len(vals) if vals else None
