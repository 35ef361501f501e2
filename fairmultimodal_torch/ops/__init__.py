"""Ops of the port: the CUDA half-layer kernels with their plain versions,
attention, and the kernel-path gates."""
