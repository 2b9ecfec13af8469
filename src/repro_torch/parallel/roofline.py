"""Three-term roofline on an NVIDIA H100 SXM from counted costs.

The port of `repro.parallel.roofline`, with the H100's constants in place
of the TPU's:

  compute_s    = FLOPs_per_device / peak_FLOP/s
  memory_s     = bytes_per_device / HBM_bw
  collective_s = collective_bytes_per_device / link_bw

`repro` reads its terms from a compiled XLA module's HLO
(``parallel/hlo_analysis.py``); the port takes them from a counted `Costs`
record, which `repro_torch.parallel.cost_count` counts from one step run
on meta tensors (`repro_torch.launch.dryrun`).

MODEL_FLOPS uses `repro`'s convention: 6·N·D for training (N = active
params, D = global tokens per step), 2·N·D for prefill, 2·N·B for decode
(one token per sequence). The useful-compute ratio MODEL_FLOPS /
(FLOPs · chips) exposes recomputation and duplicated work.
"""
from __future__ import annotations

import dataclasses
import math

# H100 SXM5 (80 GB HBM3), per card, from the NVIDIA H100 Tensor Core GPU
# data sheet: dense bf16 tensor-core peak, HBM3 bandwidth, memory size
PEAK_FLOPS = 989e12          # bf16, dense
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80 * 10**9       # 80 GB
# NVLink 4 on the SXM5 card: the data sheet's "NVLink: 900GB/s" is 18
# links x 50 GB/s counting both directions; a collective's bytes leave a
# card at half of it
LINK_BW = 450e9              # bytes/s, one direction, all links


def param_counts(cfg) -> tuple[int, int]:
    """(total, active) parameter counts of ``cfg`` at its full size, from a
    fake-tensor init (nothing is allocated). An MoE config's active count
    leaves out the routed experts a token does not pick: ``(n_experts -
    top_k)`` of them in each MoE layer, 3 · d_model · d_ff_expert each."""
    from repro_torch.parallel.sharding import param_shapes
    from repro_torch.utils.tree import tree_leaves

    total = sum(math.prod(x.shape) for x in tree_leaves(param_shapes(cfg)))
    active = total
    if cfg.moe:
        moe_layers = cfg.n_layers - cfg.first_dense
        per_expert = 3 * cfg.d_model * cfg.d_ff_expert
        active -= moe_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return total, active


def model_flops(cfg, kind: str, global_batch: int, seq_len: int, *,
                n_active: int | None = None) -> float:
    """MODEL_FLOPS of one step: ``kind`` "train" (6·N·B·S), "prefill"
    (2·N·B·S) or "decode" (2·N·B). ``n_active`` skips `param_counts`."""
    if n_active is None:
        _, n_active = param_counts(cfg)
    if kind == "train":
        return 6.0 * n_active * global_batch * seq_len
    if kind == "prefill":
        return 2.0 * n_active * global_batch * seq_len
    if kind == "decode":
        return 2.0 * n_active * global_batch
    raise ValueError(f"kind {kind!r} is not train, prefill or decode")


@dataclasses.dataclass
class Costs:
    """Counted per-device costs of one step (the counterpart of `repro`'s
    ``HloCosts``): FLOPs, bytes moved to and from HBM, bytes a collective
    sends off the card, and optionally those bytes by collective."""
    flops: float
    bytes: float
    collective_bytes: float = 0.0
    collectives: dict | None = None


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                 # per device
    bytes: float                 # per device
    collective_bytes: float      # per device
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float           # global
    useful_ratio: float
    device_mem_bytes: int | None = None
    fits_hbm: bool | None = None
    collectives: dict | None = None

    def row(self) -> dict:
        return dataclasses.asdict(self)


def roofline_from_costs(costs: Costs, *, cfg, kind: str, global_batch: int, seq_len: int,
                        mesh_name: str, chips: int, device_mem_bytes: int | None = None,
                        n_active: int | None = None) -> Roofline:
    """The three terms of ``costs`` on this card, the largest named as the
    bottleneck, beside the step's MODEL_FLOPS (`model_flops`)."""
    compute_s = costs.flops / PEAK_FLOPS
    memory_s = costs.bytes / HBM_BW
    coll_s = costs.collective_bytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    mf = model_flops(cfg, kind, global_batch, seq_len, n_active=n_active)
    return Roofline(
        arch=cfg.name, shape=f"{kind}_b{global_batch}_s{seq_len}", mesh=mesh_name, chips=chips,
        flops=costs.flops, bytes=costs.bytes, collective_bytes=costs.collective_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        bottleneck=max(terms, key=terms.get), model_flops=mf,
        useful_ratio=mf / (costs.flops * chips) if costs.flops else 0.0,
        device_mem_bytes=device_mem_bytes,
        fits_hbm=None if device_mem_bytes is None else device_mem_bytes <= HBM_BYTES,
        collectives=None if costs.collectives is None else dict(costs.collectives),
    )


__all__ = ["PEAK_FLOPS", "HBM_BW", "HBM_BYTES", "LINK_BW", "param_counts", "model_flops",
           "Costs", "Roofline", "roofline_from_costs"]
