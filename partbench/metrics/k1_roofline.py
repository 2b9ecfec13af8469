"""k1_roofline: K1's byte bound (`roofline.k1_bytes` for each block of each
profiled Revolver superstep) at the HBM peak over K1's device time in the
profile (its span kernel and the hub-row pass after it), in %."""
from partbench import roofline


def read(run):
    p = run.profile
    if p is None or run.algo != "revolver" or p.seconds("edge_phase_span_kernel") is None:
        return None
    g = run.graph
    per_step = roofline.kernel_bytes_per_superstep(run.algo, g["block_live"], g["block_v"],
                                                   g["n_pad"], run.k)["k1"]
    return roofline.share_pct(per_step * p.steps,
                              p.seconds("edge_phase_span_kernel", "hub_add_kernel"))
