"""CUDA kernels built from csrc/ with nvcc, bound through ctypes."""
