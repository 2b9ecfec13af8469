"""PyTorch/CUDA port of the Revolver partitioner.

A second package beside the JAX reference `repro`: it imports `torch` and
`numpy` only, follows `repro`'s module layout and names, and runs the
edge phase and the learning-automaton update through hand-written CUDA
kernels (`repro_torch.kernels`) on an NVIDIA Hopper GPU. Entry points
default to ``device="cuda"`` and raise when no CUDA device is present;
pass ``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""
