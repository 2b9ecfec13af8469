"""k3_roofline: K3's byte bound (`roofline.k3_bytes`, the gather form, for
each launch of each profiled Spinner or restream superstep) at the HBM
peak over K3's device time (its span kernel and the hub-row pass), in %."""
from partbench import roofline


def read(run):
    p = run.profile
    if (p is None or run.algo not in ("spinner", "restream")
            or p.seconds("edge_histogram_span_kernel") is None):
        return None
    g = run.graph
    per_step = roofline.kernel_bytes_per_superstep(run.algo, g["block_live"], g["block_v"],
                                                   g["n_pad"], run.k)["k3"]
    return roofline.share_pct(per_step * p.steps,
                              p.seconds("edge_histogram_span_kernel", "hub_add_kernel"))
