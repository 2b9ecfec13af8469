"""Hand-written Hopper kernels of the partitioner, with their plain versions.

  edge_phase   K1: fused dual-histogram edge phase (replaces
               repro.kernels.edge_phase.fused_edge_phase_pallas)
  la_update    K2: weighted-LA probability update, eqs. (8)/(9) (replaces
               repro.kernels.la_update.la_update_pallas)
  ops          device-routed public wrappers and the launch counters
  _build       nvcc build at first use and the ctypes binding

CUDA sources live in ``csrc/``; nothing is built at import time.
"""
