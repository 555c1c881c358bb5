"""Ops of the port: attention, the fused norms and the build of their
hand-written CUDA kernels, and the TP seams' collective matmul."""
