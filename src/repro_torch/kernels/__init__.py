"""Hand-written CUDA kernels for the H100 and their plain PyTorch versions.

Each kernel wrapper launches its kernel for CUDA tensors and runs its plain
version for CPU tensors; a CUDA tensor never reaches a plain version through
a wrapper.  Kernels are built from ``src/repro_torch/csrc`` at first use.
"""
