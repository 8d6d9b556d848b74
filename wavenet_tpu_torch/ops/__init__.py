"""Counter RNG and the CUDA kernels (ops/cuda)."""
