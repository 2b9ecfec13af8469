"""Hand-written Hopper kernels of the port, with their plain versions.

  edge_phase        K1: fused dual-histogram edge phase (replaces
                    repro.kernels.edge_phase.fused_edge_phase_pallas)
  la_update         K2: weighted-LA probability update, eqs. (8)/(9)
                    (replaces repro.kernels.la_update.la_update_pallas)
  edge_histogram    K3: edge label histogram of the Spinner and restream
                    rules (replaces
                    repro.kernels.edge_histogram.edge_histogram_pallas)
  flash_attention   K4: causal / sliding-window GQA attention forward
                    (replaces repro.kernels.flash_attention.flash_attention_pallas)
  decode_attention  K5: flash-decode against a KV cache (replaces
                    repro.kernels.decode_attention.decode_attention_pallas)
  wkv6              K6: the RWKV6 wkv recurrence (replaces
                    repro.kernels.wkv6.wkv6_pallas)
  hub_reconcile     H1: the hub vote reconcile of hub replication (no TPU
                    kernel: replaces repro.core.engine._hub_reconcile's
                    lax.scan)
  ops               device-routed public wrappers and the launch counters
  _build            nvcc build at first use and the ctypes binding

CUDA sources live in ``csrc/``; nothing is built at import time.
"""
