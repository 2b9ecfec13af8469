"""Revolver places MoE experts on EP devices — the PyTorch port.

The counterpart of ``examples/expert_placement.py``: a DeepSeek-style
router with clustered co-activation (experts that fire together) is
profiled; Revolver partitions the expert co-activation graph across EP
devices (`repro_torch.core.placement.place_experts` ->
`run_partitioner`, K1 and K2 on a CUDA device); the resulting placement is
compared against the naive contiguous one on cross-device co-activation
(the proxy for EP combine traffic). Then the placed layer runs
expert-parallel over an 8-rank mesh and gives the unplaced layer's output.

  PYTHONPATH=src python examples/expert_placement_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core.placement import _cross_fraction, apply_placement, place_experts
from repro_torch.launch.mesh import LMMesh
from repro_torch.models.moe import MoESpec, apply_moe, init_moe, moe_ref
from repro_torch.parallel.act_sharding import use_activation_sharding

E, DEVICES, TOKENS, TOPK = 64, 8, 4000, 6


def synth_routing(seed=0):
    """Clustered routing with a hidden (shuffled) block structure."""
    rng = np.random.default_rng(seed)
    hidden = rng.permutation(E)                       # shuffle expert ids
    clusters = hidden.reshape(DEVICES, E // DEVICES)  # true co-activation groups
    grp = rng.integers(0, DEVICES, TOKENS)
    cols = rng.integers(0, E // DEVICES, (TOKENS, TOPK))
    return clusters[grp[:, None], cols]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    dev = torch.device(ap.parse_args().device)

    top = synth_routing()
    naive = np.arange(E) // (E // DEVICES)
    pl = place_experts(top, E, DEVICES, max_steps=120, device=dev)
    print(f"cross-device co-activation: naive={_cross_fraction(top, naive):.3f} "
          f"revolver={pl.cross_coactivation:.3f}")
    print(f"partitioner: local_edges={pl.result.local_edges:.3f} "
          f"max_norm_load={pl.result.max_norm_load:.3f} steps={pl.result.steps}")

    # placement is a pure relabeling: module outputs are unchanged
    spec = MoESpec(d_model=16, n_experts=E, top_k=2, d_ff_expert=32, capacity_factor=E / 2)
    gen = torch.Generator(device=dev).manual_seed(0)
    moe = init_moe(gen, spec, torch.float32)
    x = torch.randn((2, 8, 16), generator=gen, device=dev)
    placed = apply_placement(moe, pl)
    torch.testing.assert_close(moe_ref(placed, x, spec), moe_ref(moe, x, spec),
                               atol=1e-5, rtol=1e-5)
    # expert-parallel over 8 ranks on the one device: rank r holds the
    # experts Revolver gave device r
    with use_activation_sharding(LMMesh((1, DEVICES), ("data", "model"), [dev] * DEVICES)):
        y_ep = apply_moe(placed, x, spec)
    torch.testing.assert_close(y_ep, apply_moe(moe, x, spec), atol=1e-5, rtol=1e-5)
    print("placement-permuted MoE outputs identical, and expert-parallel over "
          f"{DEVICES} ranks — placement is free at the model level; it only changes "
          "which device owns which expert.")


if __name__ == "__main__":
    main()
