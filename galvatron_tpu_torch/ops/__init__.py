"""Attention ops of the port and the build of their hand-written CUDA kernels."""
