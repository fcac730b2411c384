"""Kernels of the port: each wrapper launches its hand-written CUDA kernel
on a CUDA tensor and runs its plain PyTorch version on a CPU tensor."""
