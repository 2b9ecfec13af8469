"""k2_roofline: K2's byte bound (`roofline.k2_bytes` for each block of each
profiled Revolver superstep) at the HBM peak over K2's device time, in %."""
from partbench import roofline


def read(run):
    p = run.profile
    if p is None or run.algo != "revolver" or p.seconds("la_update_kernel") is None:
        return None
    g = run.graph
    per_step = roofline.kernel_bytes_per_superstep(run.algo, g["block_live"], g["block_v"],
                                                   g["n_pad"], run.k)["k2"]
    return roofline.share_pct(per_step * p.steps, p.seconds("la_update_kernel"))
