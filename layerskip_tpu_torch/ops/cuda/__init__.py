"""Hand-written CUDA kernels (csrc/) and their wrappers."""
