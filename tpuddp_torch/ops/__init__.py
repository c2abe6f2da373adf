"""Hand-written kernels of the port (CUDA C++ for Hopper, under ``csrc/``),
each beside its plain PyTorch version."""
