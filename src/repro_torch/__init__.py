"""PyTorch/CUDA port of the Revolver partitioner and its LM serving stack.

A second package beside the JAX reference `repro`: it imports `torch` and
`numpy` only and follows `repro`'s module layout and names. The
partitioner's edge phase and learning-automaton update, and the dense
decoder's prefill and decode attention, run through hand-written CUDA
kernels (`repro_torch.kernels`) on an NVIDIA Hopper GPU. Entry points
default to ``device="cuda"`` and raise when no CUDA device is present;
pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
