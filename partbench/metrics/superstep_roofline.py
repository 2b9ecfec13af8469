"""superstep_roofline: the least bytes one superstep of the cell's rule
must move (`roofline.superstep_bytes`) at the HBM peak, over the window's
superstep wall time: the whole step's share of the chip's bandwidth, in %."""
from partbench import roofline


def read(run):
    steps = sum(j.steps for j in run.jobs)
    if not steps:
        return None
    g = run.graph
    nbytes = roofline.superstep_bytes(run.algo, g["entries"], g["n_pad"], run.k)
    return roofline.share_pct(nbytes * steps, sum(j.wall_s for j in run.jobs))
