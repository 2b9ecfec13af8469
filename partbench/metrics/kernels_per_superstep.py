"""kernels_per_superstep: device kernels (copies and fills apart) in the
profiled jobs over their supersteps."""


def read(run):
    p = run.profile
    if p is None or not p.steps or not p.kernels:
        return None
    return p.kernels / p.steps
